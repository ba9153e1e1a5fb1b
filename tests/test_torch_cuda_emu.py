"""The CUDA kernel sources of setk_tpu_torch, run on the CPU.

The sources under setk_tpu_torch/csrc compile with the host C++ compiler
against tests/cuda_emu/cuda_runtime.h, a CPU stand-in for the CUDA
runtime (blocks in order, a block's threads as std::threads with a
barrier), and run through their C entry points on CPU tensors.  This
checks the kernels' index arithmetic, FFT, reductions, overlap-add,
the online pair's chunking and EMA, the per-bin solves, the planar
STFT/iSTFT (center on and off, any length; the warp transform forward and
inverse at every n_fft, runs and tiles that T does not fill, the iSTFT
with and without the beamform), the
pair covariance (N = 1, 6 and 8, complement mask or two masks), the
masked covariance against K classes (warp shuffles), the Jacobi
regularized inverse, the fused CGMM/CACGMM EM (both models, both
entries, a frame mask, K = 3) and the BLSTM recurrence forward and
backward (f32 and bf16 weights, T = 1, ragged last row tiles; kernels 20
and 21's resident variants as cooperative launches on an emulated card of
6 SMs, with ragged unit slices, idle blocks, several h tiles and, for
kernel 21, several dgates chunks and batch tiles) against their
plain PyTorch versions without a card; it says nothing of speed, and the
card's own compiler is checked by chip_smoke.py.  Skips when no g++ with
C++20 is present (decided inside the fixture).
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
from setk_tpu_torch.ops.cuda import cacgmm_em as ce
from setk_tpu_torch.ops.cuda import cholesky as ch
from setk_tpu_torch.ops.cuda import covariance as mc
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import eigh_small as es
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import lstm_seq as ls
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.ops.cuda import planar as pl
from setk_tpu_torch.ops.cuda import wpe_gram as wg

EMU = Path(__file__).resolve().parent / "cuda_emu"
TOL = 1e-5   # f32 radix-2 FFT against pocketfft, f32 sums in another order
# the family's solves: 30 power iterations or N right-hand sides through an
# N = 8 Cholesky, each sum in another order than torch's; the bar the
# kernels are held to on the card
SOLVE_TOL = 1e-4
# the emulated card of the resident LSTM variant: 3 blocks a direction
EMU_SMS, EMU_SMEM = 6, 232448
_LAUNCH = re.compile(r"(\w+<[^;]*?>)<<<(.*?)>>>\(", re.S)
_DYNAMIC_SMEM = re.compile(r"extern\s+__shared__\s+(\w+)\s+(\w+)\[\];")


def _emu_library(name, out, defines=()):
    """Source ``name`` compiled with g++ against the emulator into
    ``out``, with -D ``defines``, loaded and its entry points typed."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    code = _LAUNCH.sub(r"emu_launch(\2, \1, ",
                       (_build.SOURCE_DIR / _build.SOURCES[name]).read_text())
    code = _DYNAMIC_SMEM.sub(
        r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", code)
    cpp = out / f"{name}.cpp"
    cpp.write_text(code)
    lib = out / f"lib{name}.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         *[f"-D{d}" for d in defines], f"-I{EMU}", f"-I{_build.SOURCE_DIR}",
         "-o", str(lib), str(cpp)], capture_output=True, text=True)
    if proc.returncode != 0 and "c++20" in proc.stderr:
        pytest.skip("g++ without C++20 support")
    assert proc.returncode == 0, proc.stderr[-4000:]
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in _build._SIGNATURES[name].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    handle.emu_set_device_attributes(EMU_SMS, EMU_SMEM)
    return handle


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu")
    return {name: _emu_library(name, out) for name in _build.SOURCES}


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


# online pair: chunks that do and do not divide kernel B's tile of 8
# frames, so a pair of frames, a tile or a run ends inside a chunk (16),
# mid-chunk (5) or both (24); chunk 1 is one frame a chunk (at T = 81, two
# of covar_ema's tiles of 64 chunks), 64 one chunk for every frame
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


# kernel A's tiles and segments: N = 1, 2, 5, 7 and 8 (odd N: the last
# transform carries one mic), T = 3 (S = 512), T that leaves the last
# tile of 8 frames (4 at N = 3) short, run counts that do not divide T
# (T = 9 in 4 runs of 3: the last run is empty and written as zeros), one
# run (Rs, Rn written by kernel A itself) and a waveform and mask that are
# not 16-byte aligned (the samples copied one by one, the mask's ends)
KERNEL_A = [(1, 1, 4096, True, 1, 0), (1, 2, 512, False, 1, 0),
            (1, 2, 512, True, 3, 0), (1, 5, 5120, True, 3, 0),
            (1, 8, 3072, False, 2, 0), (2, 5, 2560, False, 4, 0),
            (1, 7, 4096, True, 5, 0), (1, 3, 2048, True, 4, 0),
            (1, 5, 4096, True, 2, 1), (1, 8, 2560, False, 1, 1)]


def _kernel_a_inputs(b, n, s, int16, offset, seed):
    """_inputs with the waveform and the mask ``offset`` elements into
    their storage."""
    cfg, wav, mask = _inputs(b, n, s, int16, seed)
    if offset:
        def shifted(x):
            store = torch.zeros(offset + x.numel(), dtype=x.dtype)
            store[offset:] = x.reshape(-1)
            return store[offset:].view(x.shape)
        wav, mask = shifted(wav), shifted(mask)
        assert wav.data_ptr() % 16 != 0 and mask.data_ptr() % 16 != 0
    return cfg, wav, mask


@pytest.mark.parametrize("b,n,s,int16,runs,offset", KERNEL_A)
def test_kernel_a_tiles_and_runs_match_plain(libs, b, n, s, int16, runs,
                                             offset):
    cfg, wav, mask = _kernel_a_inputs(b, n, s, int16, offset, seed=n + runs)
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    part = torch.empty((b, runs, 257, n * (n + 1)), dtype=torch.complex64)
    rs = torch.empty((b, 257, n, n), dtype=torch.complex64)
    rn = torch.empty_like(rs)
    assert libs["fused_mvdr"].stft_covar_launch(
        wav.data_ptr(), mask.data_ptr(), win.data_ptr(), part.data_ptr(),
        rs.data_ptr(), rn.data_ptr(), b, n, s, runs, int(int16), None) == 0
    rs_p, rn_p = fm.stft_covar_plain(wav, mask, window)
    assert _rel(rs, rs_p) < TOL and _rel(rn, rn_p) < TOL


# the per-chunk entry: chunks 1, 5, 24 and 64, a chunk larger than T
# (T = 3 and T = 17), chunks that end inside a tile and blocks that take
# several chunks (chunk 3 at T = 33: two chunks a block on the emulated
# card's 6 SMs), an unaligned waveform and mask
KERNEL_A_CHUNKS = [(1, 1, 2048, True, 1, 0), (1, 5, 4096, False, 5, 0),
                   (1, 8, 6144, True, 24, 0), (2, 2, 4096, False, 64, 0),
                   (1, 6, 512, True, 5, 0), (1, 4, 8192, True, 3, 0),
                   (1, 7, 2560, False, 5, 1)]


@pytest.mark.parametrize("b,n,s,int16,chunk,offset", KERNEL_A_CHUNKS)
def test_kernel_a_chunks_match_plain(libs, b, n, s, int16, chunk, offset):
    cfg, wav, mask = _kernel_a_inputs(b, n, s, int16, offset, seed=n + chunk)
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    part = torch.empty((b, fm.num_chunks(cfg.num_frames(s), chunk), 257,
                        n * (n + 1)), dtype=torch.complex64)
    assert libs["fused_mvdr"].stft_covar_chunks_launch(
        wav.data_ptr(), mask.data_ptr(), win.data_ptr(), part.data_ptr(), b,
        n, s, chunk, int(int16), None) == 0
    ref = fm.stft_covar_chunks_plain(wav, mask, window, chunk)
    assert _rel(part, ref) < TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_a_transform_matches_rfft(libs, seed):
    """Kernel A's warp transform alone (stft_covar_transform_launch) on
    windowed rows: five pairs of rows, a pair a warp, the two rows of a
    pair split from one complex transform; an impulse at sample 1 and a
    constant row in the first pair."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((5, 2, 512)).astype(np.float32)
    frames[0, 0] = 0.0
    frames[0, 0, 1] = 1.0
    frames[0, 1] = 0.25
    frames = torch.from_numpy(frames)
    spec = torch.empty((5, 2, 257), dtype=torch.complex64)
    assert libs["fused_mvdr"].stft_covar_transform_launch(
        frames.data_ptr(), spec.data_ptr(), 5, None) == 0
    ref = torch.fft.rfft(frames.double(), dim=-1)
    assert _rel(spec.to(torch.complex128), ref) < TOL


@pytest.mark.parametrize("n", range(0, 10))
def test_kernel_a_layout(libs, n):
    """stft_covar_layout: one transform a warp a tile, the pair shares a
    thread each at every bin slot, within the card's 227 KB; N outside
    1..8 refused."""
    out = (ctypes.c_int * 5)()
    for int16 in (1, 0):
        err = libs["fused_mvdr"].stft_covar_layout(n, int16,
                                                   ctypes.addressof(out))
        if not 1 <= n <= 8:
            assert err != 0
            continue
        assert err == 0
        per_sm, threads, tile, smem, sms = out
        warps, pairs = threads // 32, (n + 1) // 2
        assert threads % 256 == 0 and tile * pairs == warps
        shares = threads // 256
        assert -(-(n * (n + 1) // 2) // shares) <= 9
        assert smem <= EMU_SMEM and per_sm >= 1 and sms == EMU_SMS


@pytest.mark.parametrize("batch,frames,want", [
    (128, 501, 1), (64, 501, 2), (100, 501, 1), (1, 501, 62), (1, 251, 31),
    (3, 20, 2), (200, 501, 1), (33, 501, 4)])
def test_kernel_a_runs_fill_the_card(batch, frames, want):
    """Runs of frames a block each: the fewest that fill 132 SMs' blocks
    (one block an SM) as well as any count, a tile of 8 frames a run at
    least."""
    assert fm.frame_runs(batch, frames, 132, 8) == want


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


def _kernel_b_weights(b, n, c, seed):
    """Random complex weights (B, 257, N), or (B, C, 257, N) for c."""
    rng = np.random.default_rng(seed)
    shape = (b, 257, n) if c is None else (b, c, 257, n)
    return torch.from_numpy((rng.standard_normal(shape) + 1j *
                             rng.standard_normal(shape)).astype(
                                 np.complex64))


def _kernel_b_case(libs, b, n, s, int16, chunk, offset, seed):
    """Kernel B (offline for chunk None, else the online entry) against
    its plain version: max |diff| / max |plain|."""
    cfg, wav, _ = _kernel_a_inputs(b, n, s, int16, offset, seed)
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    t = cfg.num_frames(s)
    wss = torch.from_numpy(wss_inverse_blocks(cfg.padded_window, t, 256,
                                              512, s))
    out = torch.empty((b, s), dtype=torch.float32)
    lib = libs["fused_mvdr"]
    if chunk is None:
        w = _kernel_b_weights(b, n, None, seed)
        assert lib.beamform_istft_launch(
            wav.data_ptr(), w.data_ptr(), wss.data_ptr(), win.data_ptr(),
            window.data_ptr(), out.data_ptr(), b, n, s, int(int16),
            None) == 0
        ref = fm.beamform_istft_plain(wav, w, wss, window)
    else:
        w = _kernel_b_weights(b, n, fm.num_chunks(t, chunk), seed)
        assert lib.beamform_istft_online_launch(
            wav.data_ptr(), w.data_ptr(), wss.data_ptr(), win.data_ptr(),
            window.data_ptr(), out.data_ptr(), b, n, s, chunk, int(int16),
            None) == 0
        ref = fm.beamform_istft_online_plain(wav, w, wss, window, chunk)
    return _rel(out, ref)


def _kernel_b_runs(libs, b, n, s, int16, online):
    out = (ctypes.c_int * 6)()
    assert libs["fused_mvdr"].beamform_istft_layout(
        n, int(int16), int(online), b, s, ctypes.addressof(out)) == 0
    return out[5]


# kernel B's tiles (8 frames, a pair a warp) and runs: N = 1, 2, 5 and 8
# (odd N: the last transform carries one mic), int16 and f32, a waveform
# off 16-byte alignment (the samples copied one by one), B = 1 at S = 512
# (T = 3: one short tile, the second frame of its last pair past the run),
# runs that end inside a tile and several runs an utterance (B = 1 on the
# emulated card's 6 SMs), pairs past the run in a short last tile
KERNEL_B = [(1, 1, 4096, True, 0), (1, 2, 512, False, 0),
            (1, 5, 5120, True, 0), (2, 8, 2560, False, 0),
            (1, 5, 4096, False, 1), (1, 8, 3328, True, 0),
            (2, 3, 1536, True, 1)]


@pytest.mark.parametrize("b,n,s,int16,offset", KERNEL_B)
def test_kernel_b_tiles_and_runs_match_plain(libs, b, n, s, int16, offset):
    assert _kernel_b_case(libs, b, n, s, int16, None, offset,
                          seed=n + s) < TOL


def test_kernel_b_cases_take_several_runs(libs):
    """The cases above reach several runs an utterance, one run, and runs
    whose frame count is odd (a pair with one frame in the run)."""
    runs = {(b, s): _kernel_b_runs(libs, b, n, s, i16, False)
            for b, n, s, i16, _ in KERNEL_B}
    assert runs[(1, 4096)] > 1 and runs[(1, 512)] == 1
    assert any(-(-(s // 256) // r) % 2 == 0 for (b, s), r in runs.items())


# online: chunk 1 (a weight row a frame), chunks that do not divide the
# tile of 8 frames (3, 5, 12: a tile's pairs in two or three chunks, a pair
# split between chunks), chunk 32 and a chunk larger than T, over several
# runs an utterance, N = 2, 6, 7, 8, int16 and unaligned f32
KERNEL_B_ONLINE = [(1, 2, 4096, True, 1, 0), (1, 6, 4096, False, 3, 1),
                   (2, 7, 3072, True, 5, 0), (1, 8, 6144, True, 12, 0),
                   (1, 6, 10240, True, 32, 0), (1, 3, 1024, False, 64, 1)]


@pytest.mark.parametrize("b,n,s,int16,chunk,offset", KERNEL_B_ONLINE)
def test_kernel_b_online_chunks_match_plain(libs, b, n, s, int16, chunk,
                                           offset):
    assert _kernel_b_case(libs, b, n, s, int16, chunk, offset,
                          seed=n + chunk) < TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_b_inverse_matches_irfft(libs, seed):
    """Kernel B's warp inverse alone (beamform_istft_inverse_launch): five
    pairs of random real spectra, a pair a warp, against torch's irfft;
    the first pair a lone bin 1 and a lone bin 256."""
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((5, 2, 257)) + 1j *
            rng.standard_normal((5, 2, 257))).astype(np.complex64)
    spec[0] = 0.0
    spec[0, 0, 1] = 1.0 - 0.5j
    spec[0, 1, 256] = 2.0
    spec = torch.from_numpy(spec)
    frames = torch.empty((5, 2, 512), dtype=torch.float32)
    assert libs["fused_mvdr"].beamform_istft_inverse_launch(
        spec.data_ptr(), frames.data_ptr(), 5, None) == 0
    ref = torch.fft.irfft(spec.to(torch.complex128), n=512, dim=-1)
    assert _rel(frames.double(), ref) < TOL


@pytest.mark.parametrize("n", range(0, 10))
def test_kernel_b_layout(libs, n):
    """beamform_istft_layout: 4 warps and 8 frames a tile, within the
    card's 227 KB, the offline weights in shared memory, and the runs an
    utterance frame_runs' rule picks; N outside 1..8 refused."""
    out = (ctypes.c_int * 6)()
    for int16 in (1, 0):
        smem = {}
        for online in (0, 1):
            err = libs["fused_mvdr"].beamform_istft_layout(
                n, int16, online, 3, 20480, ctypes.addressof(out))
            if not 1 <= n <= 8:
                assert err != 0
                continue
            assert err == 0
            per_sm, threads, tile, smem[online], sms, runs = out
            assert threads == 128 and tile == 8 and per_sm == 1
            assert smem[online] <= EMU_SMEM and sms == EMU_SMS
            assert runs == fm.frame_runs(3, 80, EMU_SMS, 8) == 2
        if smem:
            assert smem[0] - smem[1] == (n + 1) // 2 * 257 * 16


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
    """Masked covariances of a source with a per-bin steer plus noise."""
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


# kernels 4 and 5 take a lane group a bin (pmwf: the power of two >= N;
# gevd: that, at most 2) in blocks of 128 threads.  (N, bins): every N,
# with the last group's lanes past N and the last block partial, and a
# count past two blocks at every group size (128, 64, 32 and 16 bins a
# block at 1, 2, 4 and 8 lanes); gevd_power at N = 7 and 8 takes more
# than 48 KB of dynamic shared memory, which the emulator launches only
# after the kernel's opt-in
FAMILY_CASES = [(1, 1), (1, 300), (2, 3), (2, 130), (3, 33), (3, 70),
                (4, 70), (5, 1), (5, 33), (6, 33), (6, 130), (7, 3),
                (7, 70), (8, 70), (8, 130)]
# gevd_power at 30 iterations on every case, at 50 on a case past two
# blocks at N = 2, 5 and 8 (the emulator's shuffles are block barriers,
# so iterations are what its time goes on)
GEVD_CASES = ([pytest.param(n, b, 30, id=f"{n}-{b}-30")
               for n, b in FAMILY_CASES] +
              [pytest.param(n, b, 50, id=f"{n}-{b}-50")
               for n, b in ((2, 130), (5, 33), (8, 70))])


def _degenerate_bins(rs, rn, d):
    """Bins 1-3 and the last of ``bins >= 5`` made degenerate among the
    ordinary ones: Rs = 0, Rn = 0, a rank-one Rs, and both 0 (an all-zero
    bin, as padding leaves it); returns their indices."""
    bins = rs.shape[0]
    if bins < 5:
        return []
    rs[1] = 0
    rn[2] = 0
    rs[3] = d[3, :, None] * d[3, None, :].conj()
    rs[-1] = 0
    rn[-1] = 0
    return [1, 2, 3, bins - 1]


def _assert_bins_match(got, ref, degenerate):
    """Ordinary bins within SOLVE_TOL of their peak; a degenerate bin
    within SOLVE_TOL of its own peak, or exactly 0 where ref is."""
    ordinary = [k for k in range(ref.shape[0]) if k not in degenerate]
    assert _rel(got[ordinary], ref[ordinary]) < SOLVE_TOL
    for k in degenerate:
        if ref[k].abs().max() == 0:
            assert got[k].abs().max() == 0, k
        else:
            assert _rel(got[k], ref[k]) < SOLVE_TOL, k


@pytest.mark.parametrize("n,bins,iters", GEVD_CASES)
def test_gevd_power_source_matches_plain(libs, n, bins, iters):
    rs, rn, d = _family_covars(n, bins)
    degenerate = _degenerate_bins(rs, rn, d)
    v = torch.empty((bins, n), dtype=torch.complex64)
    err = libs["mvdr_power"].gevd_power_launch(
        rs.data_ptr(), rn.data_ptr(), v.data_ptr(), bins, n, iters, 1e-6,
        None)
    assert err == 0
    _assert_bins_match(v, mv.gevd_power_plain(rs, rn, iters), degenerate)


@pytest.mark.parametrize("beta,powers", [(0.0, True), (1.0, False)])
@pytest.mark.parametrize("n,bins", FAMILY_CASES)
def test_pmwf_solve_source_matches_plain(libs, n, bins, beta, powers):
    rs, rn, d = _family_covars(n, bins, seed=1)
    degenerate = _degenerate_bins(rs, rn, d)
    w = torch.empty((bins, n, n), dtype=torch.complex64)
    ps, pn = torch.empty((bins, n)), torch.empty((bins, n))
    err = libs["mvdr_power"].pmwf_solve_launch(
        rs.data_ptr(), rn.data_ptr(), w.data_ptr(),
        ps.data_ptr() if powers else None, pn.data_ptr() if powers else None,
        bins, n, beta, 1e-6, None)
    assert err == 0
    ref = mv.pmwf_solve_plain(rs, rn, beta, return_powers=True)
    _assert_bins_match(w, ref[0], degenerate)
    if powers:
        _assert_bins_match(ps, ref[1], degenerate)
        _assert_bins_match(pn, ref[2], degenerate)


def test_pmwf_solve_stores_from_any_alignment(libs):
    """Rs, Rn and W 8 bytes off a 16-byte boundary take the 8-byte
    staging and stores (an odd count of float2s a block at N = 5)."""
    rs, rn, _ = _family_covars(5, 33, seed=3)
    pad = torch.zeros((1,), dtype=torch.complex64)
    rs_off = torch.cat([pad, rs.reshape(-1)])[1:].view(rs.shape)
    rn_off = torch.cat([pad, rn.reshape(-1)])[1:].view(rn.shape)
    buf = torch.zeros(33 * 25 + 1, dtype=torch.complex64)
    w_off = buf[1:].view(33, 5, 5)
    assert rs_off.data_ptr() % 16 == 8 and w_off.data_ptr() % 16 == 8
    err = libs["mvdr_power"].pmwf_solve_launch(
        rs_off.data_ptr(), rn_off.data_ptr(), w_off.data_ptr(), None, None,
        33, 5, 0.0, 1e-6, None)
    assert err == 0 and buf[0] == 0
    assert _rel(w_off, mv.pmwf_solve_plain(rs, rn)) < SOLVE_TOL


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


# kernel 9 (a run of 64 frames a block, tiles of 8) on runs and tiles that
# T does not fill: T = 77, 73 (a second run of 13 and 9 frames), 19, 17,
# 13, 9 and 5 (an odd last tile, whose last pair has no frame b), center
# on and off, int16 and f32, and f32 rows off 16-byte alignment (offset
# samples)
PLANAR_TILES = [(256, 9800, True, False, 0),
                (256, 2304, False, True, 0),
                (512, 3300, True, False, 1),
                (512, 19000, False, False, 2),
                (1024, 9300, True, False, 3),
                (1024, 6000, False, True, 0),
                (2048, 9000, True, True, 0),
                (2048, 7000, False, False, 2)]


@pytest.mark.parametrize("n_fft,s,center,int16,offset", PLANAR_TILES)
def test_stft_planar_tiles_match_plain(libs, n_fft, s, center, int16,
                                       offset):
    """Three rows of S samples laid end to end from ``offset`` samples
    into a buffer, so that for f32 every row (offset 1-3) or every other
    row (S odd) is off 16-byte alignment and is staged sample by sample;
    the emulator's shared memory starts as NaN, so a frame that reads
    samples its block did not stage fails."""
    cfg, wav, window = _planar_inputs(n_fft, s, center, int16, seed=s)
    win = (window * fm.input_scale(wav)).contiguous()
    flat = torch.zeros(3 * s + offset, dtype=wav.dtype)
    flat[offset:] = wav.reshape(-1)
    t = cfg.num_frames(s)
    re = torch.empty((3, t, n_fft // 2))
    im = torch.empty_like(re)
    nyq = torch.empty((3, t))
    err = libs["planar_stft"].stft_planar_launch(
        flat.data_ptr() + offset * flat.element_size(), win.data_ptr(),
        re.data_ptr(), im.data_ptr(), nyq.data_ptr(), 3, s, n_fft,
        int(center), int(int16), None)
    assert err == 0
    ref = pl.stft_planar_plain(wav, window, center)
    peak = torch.complex(ref[0], ref[1]).abs().max()
    for got, want in zip((re, im, nyq), ref):
        assert float((got - want).abs().max() / peak) < TOL


@pytest.mark.parametrize("n_fft", pl.PLANAR_NFFT)
def test_stft_planar_transform_matches_rfft(libs, n_fft):
    """Kernel 9's warp transform alone (stft_planar_transform_launch) on
    windowed rows: three pairs of rows, a pair a warp, the two rows of a
    pair split from one complex transform; an impulse at sample 1 and a
    constant row in the first pair."""
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((3, 2, n_fft)).astype(np.float32)
    frames[0, 0] = 0.0
    frames[0, 0, 1] = 1.0
    frames[0, 1] = 0.25
    frames = torch.from_numpy(frames)
    spec = torch.empty((3, 2, n_fft // 2 + 1), dtype=torch.complex64)
    assert libs["planar_stft"].stft_planar_transform_launch(
        frames.data_ptr(), spec.data_ptr(), 3, n_fft, None) == 0
    ref = torch.fft.rfft(frames.double(), dim=-1)
    assert _rel(spec.to(torch.complex128), ref) < TOL


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


# kernel 10 (runs of 127 output hop blocks, 128 frames in tiles of 8; two
# frames a warp): T odd and even, at a run's end (T = 128 and, two runs,
# 255) and one block past it (129; 256) or short of it (127 and T = 128
# at nsamps (T - 2) hop), one frame pair (T = 2, 3), nsamps below, at and
# past (T - 1) hop; both entries, the beamform at N = 1, 3 and 8
ISTFT = [(256, 1, 128, 0, False), (256, 3, 129, 0, True),
         (256, 8, 127, -77, True), (256, 1, 2, 300, True),
         (512, 1, 256, 0, False), (512, 3, 255, 111, True),
         (512, 8, 128, -256, True), (1024, 1, 21, -5, False),
         (1024, 3, 20, 0, True), (2048, 1, 9, 1000, False),
         (2048, 8, 10, -1, True), (2048, 3, 3, 0, True)]


@pytest.mark.parametrize("n_fft,n,t,extra,beamform", ISTFT)
def test_istft_planar_entries_match_plain(libs, n_fft, n, t, extra,
                                          beamform):
    """istft_planar_launch on random planes (the beamformed spectrum) and
    beamform_istft_planar_launch on random mic planes and weights against
    their plain versions; samples from (T - 1) hop on are zeros.  The
    emulator's shared memory starts as NaN, so a block that reads a
    published half, a kept Q or a slot word that nothing wrote fails."""
    cfg = StftConfig(frame_len=n_fft, frame_hop=n_fft // 2)
    hop = n_fft // 2
    rng = np.random.default_rng(n_fft + 10 * n + t)
    b = 2
    re, im = (torch.from_numpy(x) for x in rng.standard_normal(
        (2, b, n, t, hop)).astype(np.float32))
    nyq = torch.from_numpy(rng.standard_normal((b, n, t)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((b, hop + 1, n)) + 1j *
                          rng.standard_normal((b, hop + 1, n))).astype(
                              np.complex64))
    window = torch.as_tensor(cfg.padded_window)
    nsamps = (t - 1) * hop + extra
    n_valid = pl.valid_samples(t, hop, nsamps)
    wss = torch.from_numpy(pl.istft_wss_inverse(cfg.padded_window, t,
                                                nsamps))
    out = torch.full((b, nsamps), float("nan"))
    lib = libs["planar_stft"]
    if beamform:
        err = lib.beamform_istft_planar_launch(
            re.data_ptr(), im.data_ptr(), nyq.data_ptr(), w.data_ptr(),
            window.data_ptr(), wss.data_ptr(), out.data_ptr(), b, n, t,
            n_fft, n_valid, nsamps, None)
        ref = pl.beamform_istft_planar_plain(re, im, nyq, w, window, wss,
                                             nsamps)
    else:
        er, ei, ny = re[:, 0], im[:, 0], nyq[:, 0]
        err = lib.istft_planar_launch(
            er.data_ptr(), ei.data_ptr(), ny.data_ptr(), window.data_ptr(),
            wss.data_ptr(), out.data_ptr(), b, t, n_fft, n_valid, nsamps,
            None)
        ref = pl.istft_planar_plain(er, ei, ny, window, wss, nsamps)
    assert err == 0
    assert _rel(out, ref) < TOL
    assert not out[:, n_valid:].any()


@pytest.mark.parametrize("n_fft", pl.PLANAR_NFFT)
def test_istft_planar_layout_fits_a_block(libs, n_fft):
    """istft_planar_layout: kernel 10's shared memory grows with the mics'
    weights and stays within the card's 227 KB at every n_fft up to 8
    mics (the emulated card admits a block there), runs of 127 output hop
    blocks; 9 mics and n_fft 768 are refused."""
    lib = libs["planar_stft"]
    out = (ctypes.c_int * 3)()
    sizes = []
    for mics in range(0, 9):
        assert lib.istft_planar_layout(n_fft, mics,
                                       ctypes.addressof(out)) == 0
        sizes.append(out[0])
        assert out[0] <= EMU_SMEM and out[1] >= 1 and out[2] == 127
    assert sizes == sorted(sizes) and sizes[1] > sizes[0]
    assert lib.istft_planar_layout(n_fft, 9, ctypes.addressof(out)) != 0
    assert lib.istft_planar_layout(768, 1, ctypes.addressof(out)) != 0


@pytest.mark.parametrize("n_fft", pl.PLANAR_NFFT)
def test_istft_planar_inverse_matches_ifft(libs, n_fft):
    """Kernel 10's warp inverse alone (istft_planar_inverse_launch): three
    pairs of random half spectra, a pair a warp, against torch's ifft of
    their Hermitian extensions (only the real parts of bins 0 and n_fft/2
    count); the first pair a lone bin 1 and a lone Nyquist bin."""
    hop = n_fft // 2
    rng = np.random.default_rng(n_fft)
    spec = (rng.standard_normal((3, 2, hop + 1)) + 1j *
            rng.standard_normal((3, 2, hop + 1))).astype(np.complex64)
    spec[0] = 0.0
    spec[0, 0, 1] = 1.0 - 0.5j
    spec[0, 1, hop] = 2.0 + 3.0j
    spec = torch.from_numpy(spec)
    frames = torch.empty((3, 2, n_fft), dtype=torch.float32)
    assert libs["planar_stft"].istft_planar_inverse_launch(
        spec.data_ptr(), frames.data_ptr(), 3, n_fft, None) == 0
    half = spec.to(torch.complex128)
    half[..., 0] = half[..., 0].real
    half[..., hop] = half[..., hop].real
    full = torch.cat([half, half[..., 1:hop].flip(-1).conj()], dim=-1)
    ref = torch.fft.ifft(full, dim=-1)
    assert float(ref.imag.abs().max()) < 1e-12
    assert _rel(frames.double(), ref.real) < TOL


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
    for pairs, n_fft in ((0, 512), (1, 4096)):
        assert lib.stft_planar_transform_launch(p, p, pairs, n_fft,
                                                None) != 0
        assert lib.istft_planar_inverse_launch(p, p, pairs, n_fft,
                                               None) != 0
    for b, n, t, n_fft, n_valid, nsamps in ((0, 2, 9, 512, 2048, 2048),
                                            (1, 0, 9, 512, 2048, 2048),
                                            (1, 9, 9, 512, 2048, 2048),
                                            (1, 2, 9, 384, 1536, 1536),
                                            (1, 2, 1, 512, 0, 256),
                                            (1, 2, 9, 512, 2049, 4096),
                                            (1, 2, 9, 512, 2048, 2000)):
        assert lib.beamform_istft_planar_launch(p, p, p, p, p, p, p, b, n,
                                                t, n_fft, n_valid, nsamps,
                                                None) != 0
    lib = libs["covariance_pair"]
    for es, b, n, t, f, mt, mb, mn in ((1, 1, 9, 4, 8, 8, 32, p),
                                       (3, 1, 2, 4, 8, 8, 32, p),
                                       (1, 0, 2, 4, 8, 8, 32, p),
                                       (1, 1, 2, 4, 8, 7, 32, p),
                                       (1, 1, 2, 4, 8, 8, 31, p),
                                       (1, 1, 2, 4, 8, 8, 32, None)):
        assert lib.pair_covar_launch(p, p, es, p, mn, mb, mt, p, p, p, p, b,
                                     n, t, f, t, 0, None) != 0


def _cplx(rng, *shape):
    return torch.from_numpy((rng.standard_normal(shape) + 1j *
                             rng.standard_normal(shape)).astype(np.complex64))


@pytest.mark.parametrize("n,k", [(1, 1), (6, 2), (8, 3), (3, 4)])
def test_masked_covar_source_matches_plain(libs, n, k):
    """L = 2, F = 5 (ten bins, three blocks of four warps, the last one
    partial), T = 45 (lanes with one and two frames)."""
    rng = np.random.default_rng(n + k)
    lead, f, t = 2, 5, 45
    obs = _cplx(rng, lead, f, n, t)
    w = torch.from_numpy(rng.random((k, lead, f, t)).astype(np.float32))
    num = torch.empty((k, lead, f, n, n), dtype=torch.complex64)
    err = libs["covariance"].masked_covar_launch(
        obs.data_ptr(), w.data_ptr(), num.data_ptr(), lead * f, n, t, k, None)
    assert err == 0
    assert _rel(num, mc.masked_covar_plain(obs, w)) < TOL


def _hermitian(rng, count, m, rank):
    a = _cplx(rng, count, m, rank)
    return (a @ a.conj().transpose(-1, -2)).contiguous()


@pytest.mark.parametrize("m", [1, 3, 6, 8])
def test_regularized_inverse_source_matches_plain(libs, m):
    """130 matrices (two blocks, the second partial), full rank and, for
    a fifth of them, rank one (the EPSILON floor)."""
    rng = np.random.default_rng(m)
    a = _hermitian(rng, 130, m, m + 2)
    a[:26] = _hermitian(rng, 26, m, 1)
    inv = torch.empty_like(a)
    logdet = torch.empty(130)
    err = libs["eigh_small"].regularized_inverse_launch(
        a.data_ptr(), inv.data_ptr(), logdet.data_ptr(), 130, m, 6, None)
    assert err == 0
    ref_inv, ref_ld = es.jacobi_regularized_inverse_plain(a)
    peak = ref_inv.abs().amax(dim=(-1, -2))
    assert float(((inv - ref_inv).abs().amax(dim=(-1, -2)) / peak).max()) < \
        SOLVE_TOL
    assert float((logdet - ref_ld).abs().max()) < SOLVE_TOL * m


def _jacobi_cases(m, n, seed):
    """Full rank, rank one (the EPSILON floor), near-diagonal (every
    off-diagonal entry 1e-20, below the rotation's threshold), exactly
    diagonal matrices, and a diagonal one whose entries differ by 1e5,
    where tau = 1e5 / 2e-15 is past 2^64, 1 + tau^2 is inf and the
    rotation's t is 0."""
    rng = np.random.default_rng(seed)
    a = _hermitian(rng, n, m, m + 2)
    a[:4] = _hermitian(rng, 4, m, 1)
    diag = torch.diag(torch.arange(1, m + 1, dtype=torch.float32) * 0.7)
    a[4] = diag + 1e-20 * (1 + 1j) * (1 - torch.eye(m))
    a[5] = diag.to(torch.complex64)
    a[6] = (diag * torch.tensor([1e5] + [1.0] * (m - 1))).to(torch.complex64)
    return a


@pytest.mark.parametrize("m", range(1, 9))
def test_regularized_inverse_edge_cases_match_plain(libs, m):
    """Kernel 14 on the cases of _jacobi_cases, 37 matrices (a partial
    last warp), a logdet pointer of null for one launch: within SOLVE_TOL
    of each matrix's peak of the plain Jacobi, logdet within SOLVE_TOL *
    M, and the same inverse without the logdet."""
    n = 37
    a = _jacobi_cases(m, n, seed=10 * m)
    inv = torch.empty_like(a)
    logdet = torch.empty(n)
    lib = libs["eigh_small"]
    assert lib.regularized_inverse_launch(a.data_ptr(), inv.data_ptr(),
                                          logdet.data_ptr(), n, m, 6,
                                          None) == 0
    ref_inv, ref_ld = es.jacobi_regularized_inverse_plain(a)
    peak = ref_inv.abs().amax(dim=(-1, -2))
    assert float(((inv - ref_inv).abs().amax(dim=(-1, -2)) / peak).max()) < \
        SOLVE_TOL
    assert float((logdet - ref_ld).abs().max()) < SOLVE_TOL * m
    again = torch.empty_like(a)
    assert lib.regularized_inverse_launch(a.data_ptr(), again.data_ptr(),
                                          None, n, m, 6, None) == 0
    assert torch.equal(again, inv)


def _eigh_cases(m, n, seed, gen):
    """n matrices for the EVD: full rank, rank one plus noise at 1e-3,
    an all-zero matrix, a scaled identity, a diagonal with tied entries
    and (with b) an all-zero b; the rest well conditioned.  Returns
    (a, b or None)."""
    rng = np.random.default_rng(seed)
    a = _hermitian(rng, n, m, m + 2)
    a[:4] = _hermitian(rng, 4, m, 1) + 1e-3 * _hermitian(rng, 4, m, m)
    a[4] = 0
    a[5] = 0.7 * torch.eye(m)
    a[6] = torch.diag(torch.tensor([0.5, 2.0] * m)[:m]).to(torch.complex64)
    if not gen:
        return a, None
    b = _hermitian(rng, n, m, m + 3) + 0.1 * torch.eye(m)
    b[7] = 0
    return a, b


# what the outputs hold before a launch: a slot the kernel never writes
# keeps it
_UNWRITTEN = 7.5e30


def _eigh_launch(lib, a, b, sweeps=es.EIGH_SWEEPS, form=None):
    """The EVD entry (``form`` None: the launcher's pick; 0 a thread a
    matrix, 1 a lane group) on outputs filled with _UNWRITTEN."""
    n, m = a.shape[0], a.shape[-1]
    w = torch.full((n, m), _UNWRITTEN)
    v = torch.full_like(a, _UNWRITTEN)
    args = (a.data_ptr(), None if b is None else b.data_ptr(), w.data_ptr(),
            v.data_ptr(), n, m, sweeps, 1e-6)
    if form is None:
        err = lib.hermitian_eigh_launch(*args, None)
    else:
        err = lib.hermitian_eigh_form_launch(*args, form, None)
    assert err == 0
    return w, v


def _separated_cosines(w, v, w_ref, v_ref, gap):
    """|cos| between each column and the reference's where the eigenvalue
    lies more than ``gap`` of the matrix's peak from its neighbours (an
    eigenvector's phase is arbitrary, and within a cluster so is its
    direction)."""
    peak = w_ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    pad = torch.full_like(w_ref[:, :1], float("inf"))
    left = torch.cat([pad, w_ref[:, 1:] - w_ref[:, :-1]], -1)
    right = torch.cat([w_ref[:, 1:] - w_ref[:, :-1], pad], -1)
    alone = torch.minimum(left, right) > gap * peak
    cos = (v.conj() * v_ref).sum(-2).abs() / (
        torch.linalg.vector_norm(v, dim=-2) *
        torch.linalg.vector_norm(v_ref, dim=-2))
    return cos[alone]


@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
def test_hermitian_eigh_source_matches_plain(libs, m, gen):
    """The EVD kernel (plain and generalized) on 130 matrices (two blocks,
    the second partial) of _eigh_cases against hermitian_eigh_plain:
    eigenvalues ascending and within SOLVE_TOL of each matrix's peak,
    every slot written, each eigenvector whose eigenvalue stands apart
    (1e-2 of the peak) within 1e-5 of the plain one's direction (a
    converged rotation still turns a column's phase by that of a rounding
    residue, so phases differ); without b, V unitary, V diag(w) V^H the
    input, and the zero, scaled identity and tied diagonal matrices with
    V = I exactly, ties in index order, so the zero matrix's principal
    vector is e_(M-1), as LAPACK gives it."""
    a, b = _eigh_cases(m, 130, 20 * m + gen, gen)
    w, v = _eigh_launch(libs["eigh_small"], a, b)
    _assert_eigh_matches_plain(a, b, w, v)


def _assert_eigh_matches_plain(a, b, w, v, counted=100, cases=True):
    """test_hermitian_eigh_source_matches_plain's checks of (w, v) on
    _eigh_cases' matrices (a, b); ``cases`` False: on other matrices, so
    without the checks of _eigh_cases' special ones."""
    m = a.shape[-1]
    gen = b is not None
    w_p, v_p = es.hermitian_eigh_plain(a, b)
    assert torch.isfinite(w).all() and torch.isfinite(v).all()
    assert not (w == _UNWRITTEN).any() and not (v.real == _UNWRITTEN).any()
    peak = w_p.abs().amax(-1).clamp(min=1e-30)
    assert float(((w - w_p).abs().amax(-1) / peak).max()) < SOLVE_TOL
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    cos = _separated_cosines(w, v, w_p, v_p, 1e-2)
    assert cos.numel() >= counted and float(cos.min()) >= 1 - 1e-5
    if gen:
        return
    eye = torch.eye(m, dtype=torch.complex64)
    assert _rel(v.conj().transpose(-1, -2) @ v, eye.expand_as(v)) < 1e-5
    rec = v @ torch.diag_embed(w.to(v.dtype)) @ v.conj().transpose(-1, -2)
    assert float(((rec - a).abs().amax(dim=(-1, -2)) /
                  a.abs().amax(dim=(-1, -2)).clamp(min=1e-30)).max()) < \
        SOLVE_TOL
    if not cases:
        return
    for k in (4, 5):
        assert torch.equal(v[k], eye)
    assert torch.equal(w[4], torch.zeros(m))
    order = torch.argsort(torch.tensor([0.5, 2.0] * m)[:m], stable=True)
    assert torch.equal(v[6], eye[:, order])


@pytest.mark.parametrize("form", [0, 1])
@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
def test_hermitian_eigh_forms_match_plain(libs, m, gen, form):
    """Each form forced (0 a thread a matrix, 1 a lane group) on 130 of
    _eigh_cases' matrices, a distinct diagonal at 7 (with b: b = 0 there):
    the first warp holds matrices converged at the first test (zero,
    scaled identity, diagonals) beside full ones, and the last block is
    partial; the checks of test_hermitian_eigh_source_matches_plain, and
    the distinct diagonal sorted with V its permutation.  A form not
    built at M (eigh_forms: a thread at M = 8, lanes at M = 1) is
    refused."""
    a, b = _eigh_cases(m, 130, 30 * m + gen, gen)
    a[7] = torch.diag(torch.arange(m, 0, -1, dtype=torch.float32) * 0.3)
    if ("thread", "lanes")[form] not in es.eigh_forms(m):
        p = a.data_ptr()
        assert libs["eigh_small"].hermitian_eigh_form_launch(
            p, None if b is None else b.data_ptr(), p, p, 130, m, 8, 1e-6,
            form, None) != 0
        return
    w, v = _eigh_launch(libs["eigh_small"], a, b, form=form)
    _assert_eigh_matches_plain(a, b, w, v)
    if not gen:
        eye = torch.eye(m, dtype=torch.complex64)
        assert torch.equal(v[7], eye.flip(-1))
        assert torch.equal(w[7], torch.arange(1, m + 1) * 0.3)


def _near_diagonal(m, count):
    """``count`` matrices that pass the EVD's stopping test as loaded but
    whose rotation would turn them: ascending diagonal 1, 1 + 2 EPS, 2,
    3, ..., and a_01 = (0.6 + 0.8i) 1e-7, under the bar M EPS ||A||_F
    (3.4e-7 at M = 2; a rotation there has tau ~ 1.2, t ~ 0.36)."""
    a = torch.diag(torch.tensor([1.0, 1.0 + 2 * 2.0 ** -23] +
                                list(range(2, m)))[:m])
    a = a.to(torch.complex64)
    a[0, 1] = complex(0.6e-7, 0.8e-7)
    a[1, 0] = complex(0.6e-7, -0.8e-7)
    return a.expand(count, m, m).clone()


@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("m,form", [
    (m, form) for m in range(2, 9) for form in (0, 1)
    if ("thread", "lanes")[form] in es.eigh_forms(m)])
def test_hermitian_eigh_form_stops_once_converged(libs, m, form, gen):
    """Each form on 130 matrices, full rank and _near_diagonal's in turn
    (with b: the identity for the near-diagonal ones), so every warp and
    lane group runs sweeps for its full matrices beside matrices that have
    stopped: the near-diagonal ones take no sweep (the plain version
    counts 0) and come out with V diagonal, the identity without b, and w
    their diagonal.  A group that sweeps on past its matrix's stop (at M
    = 5 and 6 the lane form's idle lane) turns them."""
    rng = np.random.default_rng(80 + 2 * m + gen)
    a = _hermitian(rng, 130, m, m + 2)
    a[1::2] = _near_diagonal(m, 65)
    b = None
    if gen:
        b = _hermitian(rng, 130, m, m + 3) + 0.1 * torch.eye(m)
        b[1::2] = torch.eye(m)
    taken = es.eigh_sweeps_needed(a, b)
    assert bool((taken[1::2] == 0).all()) and bool((taken[::2] > 0).all())
    w, v = _eigh_launch(libs["eigh_small"], a, b, form=form)
    w_p, v_p = es.hermitian_eigh_plain(a, b)
    off = ~torch.eye(m, dtype=torch.bool)
    for x, y in ((w, v), (w_p, v_p)):
        assert torch.equal(y[1::2][:, off], torch.zeros(65, m * (m - 1),
                                                        dtype=y.dtype))
        if not gen:
            assert torch.equal(y[1::2], torch.eye(m, dtype=y.dtype).expand(
                65, m, m))
            assert torch.equal(x[1::2], a[1::2].diagonal(0, -2, -1).real)
    _assert_eigh_matches_plain(a[::2].contiguous(),
                               None if b is None else b[::2].contiguous(),
                               w[::2], v[::2], counted=50, cases=False)


@pytest.mark.parametrize("m", range(2, 9))
def test_hermitian_eigh_small_batch_takes_lane_groups(libs, m):
    """13 matrices take the lane form (hermitian_eigh_pick) where it is
    built (M >= 4), in one 32-lane block whose last groups lie past n,
    and a thread a matrix at M <= 3; the same outputs as that form
    forced, and the plain version's."""
    lib = libs["eigh_small"]
    form = 1 if "lanes" in es.eigh_forms(m) else 0
    assert lib.hermitian_eigh_pick(13, m) == form
    a, _ = _eigh_cases(m, 13, 50 + m, False)
    w, v = _eigh_launch(lib, a, None)
    w1, v1 = _eigh_launch(lib, a, None, form=form)
    assert torch.equal(w, w1) and torch.equal(v, v1)
    _assert_eigh_matches_plain(a, None, w, v, counted=8)


@pytest.mark.parametrize("form", [0, 1])
def test_hermitian_eigh_zero_sweeps_sort_the_diagonal(libs, form):
    """sweeps = 0: every matrix's w is its sorted diagonal and V the
    identity in that order, from either form."""
    a, _ = _eigh_cases(6, 37, 7, False)
    w, v = _eigh_launch(libs["eigh_small"], a, None, sweeps=0, form=form)
    diag, order = torch.sort(a.diagonal(0, -2, -1).real, stable=True)
    eye = torch.eye(6, dtype=torch.complex64).expand_as(a)
    assert torch.equal(w, diag)
    assert torch.equal(v, eye.gather(-1, order[:, None, :].expand(-1, 6,
                                                                   -1)))


def test_hermitian_eigh_pick_by_count_and_size(libs):
    """The launcher's pick: a lane group a matrix up to its count at M =
    5-7 (8,224; 16,448; 16,448) and at every count at M = 4 and 8 (at 8 a
    thread's registers spill), a thread a matrix past it and at M <= 3;
    each picked form is one eigh_forms offers, and a form offered at
    every M is picked somewhere."""
    lib = libs["eigh_small"]
    assert lib.hermitian_eigh_pick(257, 6) == 1
    assert lib.hermitian_eigh_pick(16448, 6) == 1
    assert lib.hermitian_eigh_pick(16449, 6) == 0
    assert lib.hermitian_eigh_pick(32896, 6) == 0
    assert lib.hermitian_eigh_pick(8224, 5) == 1
    assert lib.hermitian_eigh_pick(8225, 5) == 0
    assert lib.hermitian_eigh_pick(32896, 7) == 0
    assert lib.hermitian_eigh_pick(32896, 8) == 1
    assert lib.hermitian_eigh_pick(65792, 4) == 1
    assert lib.hermitian_eigh_pick(257, 3) == 0
    assert lib.hermitian_eigh_pick(257, 1) == 0
    for m in range(1, 9):
        picked = {("thread", "lanes")[lib.hermitian_eigh_pick(n, m)]
                  for n in (1, 257, 4112, 8224, 16448, 32896, 1 << 30)}
        assert picked == set(es.eigh_forms(m))


def test_hermitian_eigh_form_entry_rejects_bad_arguments(libs):
    p = torch.zeros(8).data_ptr()
    lib = libs["eigh_small"]
    for n, m, sweeps, form in ((0, 2, 8, 0), (1, 9, 8, 1), (1, 2, -1, 0),
                               (1, 2, 8, 2), (1, 2, 8, -2), (1, 8, 8, 0),
                               (1, 4, 8, 0), (1, 1, 8, 1), (1, 3, 8, 1)):
        assert lib.hermitian_eigh_form_launch(p, None, p, p, n, m, sweeps,
                                              1e-6, form, None) != 0


def test_hermitian_eigh_nan_matrix_fills_every_slot(libs):
    """A matrix holding a NaN comes out NaN with every output slot
    written (NaN ranks last, so the ranks stay a permutation), and its
    neighbours are untouched."""
    rng = np.random.default_rng(3)
    a = _hermitian(rng, 3, 4, 6)
    a[1, 0, 2] = float("nan")
    w, v = _eigh_launch(libs["eigh_small"], a, None)
    w_p, _ = es.hermitian_eigh_plain(a)
    assert not (w == _UNWRITTEN).any() and not (v.real == _UNWRITTEN).any()
    assert torch.isnan(w[1]).any()
    for k in (0, 2):
        assert torch.isfinite(w[k]).all() and torch.isfinite(v[k]).all()
        assert _rel(w[k], w_p[k]) < SOLVE_TOL


def test_hermitian_eigh_entry_rejects_bad_arguments(libs):
    p = torch.zeros(8).data_ptr()
    lib = libs["eigh_small"]
    for n, m, sweeps in ((0, 2, 8), (1, 9, 8), (1, 0, 8), (1, 2, -1)):
        for b in (None, p):
            assert lib.hermitian_eigh_launch(p, b, p, p, n, m, sweeps, 1e-6,
                                             None) != 0


def _em_inputs(rng, b, f, m, t, k):
    obs = _cplx(rng, b, f, m, t)
    obs[:, :, 1:] += 0.5 * obs[:, :, :1]
    g0 = torch.from_numpy(rng.random((k, b, f, t)).astype(np.float32))
    return obs, g0 / g0.sum(0), torch.ones((k, b, f, t))


# (model, init, K, M, frame mask): both models and entries, K = 3, a
# (B, 1, T) frame mask read with a zero bin stride; at M = 8 the Higuchi
# init and four classes (every lane group of the warp's Jacobi busy)
EM_CASES = [("cg", "higuchi", 2, 3, False), ("cacg", None, 2, 4, True),
            ("cacg", "higuchi", 2, 2, True), ("cg", None, 3, 3, False),
            ("cg", "higuchi", 2, 8, False), ("cacg", None, 4, 8, True)]


def _em_source_case(libs, model, init, k, m, masked, b, f, t, iters, seed,
                    mask_from=None):
    """Kernel 15's source against em_plain on the caller's layout: obs
    (B, F, M, T) complex64 and the operands (K, B, F, T) as they are.  A
    frame mask zeroes the last utterance's frames from ``mask_from`` (by
    default two thirds of T) on."""
    rng = np.random.default_rng(seed)
    obs, g0, k0 = _em_inputs(rng, b, f, m, t, k)
    if model == "cacg":
        obs = obs / torch.linalg.vector_norm(obs, dim=-2, keepdim=True)
    fm = None
    if masked:
        fm = torch.ones((b, 1, t))
        fm[-1, 0, 2 * t // 3 if mask_from is None else mask_from:] = 0.0
    nb = b * f
    gamma = torch.empty((k, b, f, t))
    kern = torch.empty_like(gamma)
    q = torch.empty((iters, nb))
    covar = torch.empty((k, nb, m, m), dtype=torch.complex64)
    alpha = torch.empty((k, nb))
    strides = (0, 0, 0) if fm is None else fm.expand(b, f, t).stride()
    operands = (None, None) if init else (g0.data_ptr(), k0.data_ptr())
    err = libs["cacgmm_em"].cacgmm_em_launch(
        obs.data_ptr(), None if fm is None else fm.data_ptr(), *strides,
        *operands, gamma.data_ptr(), kern.data_ptr(), q.data_ptr(),
        covar.data_ptr(), alpha.data_ptr(), nb, f, t, m, k, iters,
        int(model == "cg"), int(init is not None), int(model == "cacg"), 6,
        None)
    assert err == 0
    ref_g, ref_q, ref_state = ce.em_plain(
        obs, None if init else g0, None if init else k0, iters, model,
        model == "cacg", frame_mask=fm, return_state=True, init=init,
        num_classes=k)
    assert float((gamma - ref_g).abs().max()) < SOLVE_TOL
    q_hist = q.sum(-1) / (fm.expand(b, f, t).sum() if masked else nb * t)
    assert float((q_hist - ref_q).abs().max()) < SOLVE_TOL * float(
        ref_q.abs().max())
    assert _rel(covar.reshape(k, b, f, m, m), ref_state["covar"]) < SOLVE_TOL
    assert float((alpha.reshape(k, b, f) - ref_state["alpha"]).abs().max()) \
        < SOLVE_TOL
    if model == "cg":
        assert _rel(kern, ref_state["phi"]) < SOLVE_TOL


@pytest.mark.parametrize("model,init,k,m,masked", EM_CASES)
def test_em_source_matches_plain(libs, model, init, k, m, masked):
    """B = 2, F = 19 (38 bins; at 8 bins a warp for K = 2, 5 for K = 3,
    4 for K = 4, a last warp with fewer), T = 21 (lanes with one frame and
    none), 4 iterations.  At M = 8, T = 64: with fewer than ~8 M frames
    the f32 EM is ill-conditioned (at T = 21, K = 4 em_plain itself lies
    0.16 from a float64 run, at T = 64 5e-5)."""
    t = 64 if m == 8 else 21
    _em_source_case(libs, model, init, k, m, masked, 2, 19, t, 4,
                    k * 10 + m, mask_from=15 if t == 21 else None)


# (model, init, K, M, F, T) at B = 1, so that a warp's last bins are idle:
# the bench's M = 6, K = 2 at T = 512 (3 bins in a warp of 8); M = 8, K = 4
# at T = 400 (3 bins in a warp of 4); K = 1 (16 bins a warp) at T = 45,
# lanes with one and two frames, over 9 bins; K = 3 at T = 100 over 5
EM_SHAPES = [("cg", "higuchi", 2, 6, 3, 512), ("cacg", None, 4, 8, 3, 400),
             ("cacg", None, 1, 5, 9, 45), ("cg", None, 3, 4, 5, 100)]


@pytest.mark.parametrize("model,init,k,m,f,t", EM_SHAPES)
def test_em_source_shapes_match_plain(libs, model, init, k, m, f, t):
    """B = 1, 3 iterations with a frame mask, at longer T and at bin
    counts that leave a warp's last bins idle."""
    _em_source_case(libs, model, init, k, m, True, 1, f, t, 3, t + m)


@pytest.mark.parametrize("m", [1, 3, 6, 8])
def test_warp_jacobi_matches_thread_jacobi(libs, m):
    """jacobi_regularized_inverse_group (16 matrices a warp, 21 of them:
    a partial last warp) against kernel 14's thread version on the same
    matrices: full rank, rank one (the EPSILON floor), and near-diagonal
    (every off-diagonal entry 1e-20, below the rotation's threshold, so
    the phase defaults to 1) and exactly diagonal ones; within a few ulps
    of each matrix's peak."""
    rng = np.random.default_rng(m + 40)
    n = 21
    a = _hermitian(rng, n, m, m + 2)
    a[:4] = _hermitian(rng, 4, m, 1)
    diag = torch.diag(torch.arange(1, m + 1, dtype=torch.float32) * 0.7)
    a[4] = diag + 1e-20 * (1 + 1j) * (1 - torch.eye(m))
    a[5] = diag.to(torch.complex64)
    got, ref = torch.empty_like(a), torch.empty_like(a)
    got_ld, ref_ld = torch.empty(n), torch.empty(n)
    assert libs["cacgmm_em"].warp_jacobi_launch(
        a.data_ptr(), got.data_ptr(), got_ld.data_ptr(), n, m, 6, None) == 0
    assert libs["eigh_small"].regularized_inverse_launch(
        a.data_ptr(), ref.data_ptr(), ref_ld.data_ptr(), n, m, 6, None) == 0
    peak = ref.abs().amax(dim=(-1, -2))
    ulp = float(np.finfo(np.float32).eps)
    assert float(((got - ref).abs().amax(dim=(-1, -2)) / peak).max()) <= \
        4 * ulp
    assert float(((got_ld - ref_ld).abs() /
                  ref_ld.abs().clamp(min=1.0)).max()) <= 4 * ulp * m
    # the near-diagonal matrix keeps its eigenvalues: the inverse of the
    # scaled diagonal
    w = torch.arange(1, m + 1, dtype=torch.float32) / m
    assert torch.allclose(got[4].diagonal().real, 1 / w, rtol=1e-6)


@pytest.mark.parametrize("m", range(1, 9))
def test_em_layout_fits_a_block(libs, m):
    """csrc/cacgmm_em.cu's layout through its C entry cacgmm_em_layout.
    Lane groups of 2: 16 bins a warp at K = 1, 8 at K = 2, 5 at K = 3 (a
    group idle), 4 at K = 4; every layout within the 48 KB a block gets
    without opting in (12,832 bytes at M = 8, K = 4), 9,280 at the
    recipes' M = 6, K = 2."""
    out = (ctypes.c_int * 3)()
    layouts = []
    for k in range(1, 5):
        assert libs["cacgmm_em"].cacgmm_em_layout(
            m, k, ctypes.addressof(out)) == 0
        layouts.append(tuple(out))
    assert [lay[:2] for lay in layouts] == [(16, 2), (8, 2), (5, 2), (4, 2)]
    assert all(lay[2] <= 48 * 1024 for lay in layouts)
    if m == 6:
        assert layouts[1][2] == 9280
    if m == 8:
        assert layouts[3][2] == 12832


@pytest.mark.parametrize("init,masked", [("higuchi", False), (None, True)])
def test_em_dispatch_launches_on_the_callers_layout(monkeypatch, init,
                                                    masked):
    """Meta tensors stand for card tensors: em launches kernel 15 once on
    obs (B, F, M, T) and the operands (K, B, F, T) as they lie, counts it
    and shapes its results; nothing is permuted into planes."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: calls.append(
                            (name, fn, args)))
    monkeypatch.setattr(ce.em, "launches", 0)
    b, f, m, t, k = 2, 5, 6, 40, 2
    obs = torch.empty((b, f, m, t), dtype=torch.complex64, device="meta")
    g0 = None if init else torch.empty((k, b, f, t), device="meta")
    fm = torch.empty((b, 1, t), device="meta") if masked else None
    gamma, q_hist, state = ce.em(obs, g0, g0, 3, "cg", False, frame_mask=fm,
                                 return_state=True, init=init)
    (name, fn, args), = calls
    assert (name, fn) == ("cacgmm_em", "cacgmm_em_launch")
    # nb, F, T, M, K, iters, cg, higuchi, update_alpha, sweeps
    assert args[12:] == (b * f, f, t, m, k, 3, 1, int(init is not None), 0,
                         es.SWEEPS)
    assert (args[1] is None) == (not masked)
    assert (args[5] is None) == (init is not None)
    assert ce.em.launches == 1
    assert gamma.shape == (k, b, f, t) and q_hist.shape == (3,)
    assert state["covar"].shape == (k, b, f, m, m)
    assert state["phi"].shape == (k, b, f, t)


def test_em_failed_launch_raises(monkeypatch):
    """A launch that fails raises; nothing falls back to em_plain and
    nothing is counted."""
    def refuse(name, fn, dev, *args):
        _build.check(1, fn)
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(ce, "em_plain", None)
    monkeypatch.setattr(ce.em, "launches", 0)
    obs = torch.empty((1, 3, 2, 8), dtype=torch.complex64, device="meta")
    with pytest.raises(RuntimeError, match="cacgmm_em_launch"):
        ce.em(obs, None, None, 2, "cacg", True, init="higuchi")
    assert ce.em.launches == 0


def test_clustering_entry_points_reject_bad_arguments(libs):
    p = torch.zeros(8).data_ptr()
    lib = libs["covariance"]
    for nbins, n, t, k in ((0, 2, 4, 1), (1, 9, 4, 1), (1, 2, 0, 1),
                           (1, 2, 4, 0), (1, 2, 4, 5)):
        assert lib.masked_covar_launch(p, p, p, nbins, n, t, k, None) != 0
    lib = libs["eigh_small"]
    for n, m, sweeps in ((0, 2, 6), (1, 9, 6), (1, 0, 6), (1, 2, -1)):
        assert lib.regularized_inverse_launch(p, p, p, n, m, sweeps,
                                              None) != 0
    lib = libs["cacgmm_em"]
    for nb, f, t, m, k, iters, higuchi in ((0, 1, 4, 2, 2, 1, 0),
                                           (6, 4, 4, 2, 2, 1, 0),
                                           (4, 4, 4, 9, 2, 1, 0),
                                           (4, 4, 4, 2, 5, 1, 0),
                                           (4, 4, 4, 2, 2, 0, 0),
                                           (4, 4, 4, 2, 3, 1, 1)):
        assert lib.cacgmm_em_launch(p, None, 0, 0, 0, p, p, p, p, p, p, p,
                                    nb, f, t, m, k, iters, 0, higuchi, 0, 6,
                                    None) != 0
    # operands missing without the Higuchi init; the layout and the warp
    # Jacobi's entries
    assert lib.cacgmm_em_launch(p, None, 0, 0, 0, None, None, p, p, p, p, p,
                                4, 4, 4, 2, 2, 1, 0, 0, 0, 6, None) != 0
    out = (ctypes.c_int * 3)()
    for m, k in ((0, 2), (9, 2), (2, 0), (2, 5)):
        assert lib.cacgmm_em_layout(m, k, ctypes.addressof(out)) != 0
    for n, m, sweeps in ((0, 2, 6), (1, 9, 6), (1, 0, 6), (1, 2, -1)):
        assert lib.warp_jacobi_launch(p, p, p, n, m, sweeps, None) != 0


def _gram(rng, bins, cols, rank=6, load=0.5):
    a = _cplx(rng, bins, cols, rank)
    return (a @ a.conj().transpose(-1, -2) + load * torch.eye(
        cols, dtype=torch.complex64)).contiguous()


# kernel 16: (n, k, hermitianize, systems).  Three systems: n = 1, 16, 37
# (rows past one warp's 32 lanes), 60 and 128 (dynamic shared memory), as
# before; then 7 systems at n = 60, k = 6 (six a block: a last block of one
# system and five clamped warps), hermitianized and not; n = 16, 31, 32 and
# 33 (a column of 31, 32 and 33 rows at the first step) at k = 1 and 8
HERMITIAN_SOLVE = [pytest.param(n, k, herm, 3, id=f"{n}-{k}-{herm}")
                   for n, k, herm in ((1, 1, True), (16, 1, True),
                                      (37, 6, False), (60, 6, True),
                                      (128, 8, False))] + [
    pytest.param(60, 6, herm, 7, id=f"60-6-{herm}-7systems")
    for herm in (True, False)] + [
    pytest.param(n, k, herm, 3, id=f"{n}-{k}-{herm}")
    for n, k, herm in ((16, 8, False), (31, 1, False), (31, 8, True),
                       (32, 1, True), (32, 8, False), (33, 1, False),
                       (33, 8, True))]


@pytest.mark.parametrize("n,k,herm,bins", HERMITIAN_SOLVE)
def test_hermitian_solve_source_matches_plain(libs, n, k, herm, bins):
    """A nudge off Hermitian where the kernel hermitianizes on load."""
    rng = np.random.default_rng(n + k)
    a = _gram(rng, bins, n, rank=n + 2, load=1.0)
    if herm:
        a = (a + 1e-3 * _cplx(rng, bins, n, n)).contiguous()
    b = _cplx(rng, bins, n, k)
    x = torch.empty_like(b)
    err = libs["cholesky"].hermitian_solve_launch(
        a.data_ptr(), b.data_ptr(), x.data_ptr(), bins, n, k, 1e-6,
        int(herm), None)
    assert err == 0
    assert _rel(x, ch.hermitian_solve_lanes_plain(
        a, b, assume_hermitian=not herm)) < SOLVE_TOL


# NK at every residue mod 4 (the TPU's unrolled substitution double-
# subtracted rows at NK % 4 in {2, 3}), the 3-mic and 6-mic defaults: (NK,
# right-hand sides = row0, systems).  Then kernel 17's warp layout: n
# below, at and past a warp's 32 lanes and up to 128 (two systems a block),
# k = 1, 6, 8 (k = 8 past 32 / k), 7 systems (5 a block at n = 60, k = 6:
# a last block with 3 clamped warps; 8 a block at n = 1: one clamped)
GRAM_SOLVE = [pytest.param(nk, 3 if nk < 60 else 6, 3, id=str(nk))
              for nk in (9, 10, 11, 12, 30, 60)] + [
    pytest.param(n, k, 7, id=f"n{n}-k{k}")
    for n, k in ((1, 1), (1, 8), (9, 6), (31, 8), (32, 1), (33, 6),
                 (60, 6), (64, 8), (128, 1), (128, 8))]


@pytest.mark.parametrize("nk,n0,bins", GRAM_SOLVE)
def test_gram_solve_source_matches_plain(libs, nk, n0, bins):
    """Kernel 17 on a Gram two columns wider than N + NK, plain and
    equilibrated on a row-scaled Gram with one empty row."""
    rng = np.random.default_rng(nk if bins == 3 else (nk, n0))
    g = n0 + nk + 2
    gram = _gram(rng, bins, g)
    x = torch.empty((bins, nk, n0), dtype=torch.complex64)
    err = libs["cholesky"].gram_solve_launch(gram.data_ptr(), x.data_ptr(),
                                             bins, g, n0, nk, n0, 1e-6, 0,
                                             None)
    assert err == 0
    assert _rel(x, ch.solve_wpe_gram_plain(gram, n0, nk, n0)) < SOLVE_TOL
    scale = torch.from_numpy(np.exp(rng.uniform(-6, 6, size=(bins, g))
                                    ).astype(np.float32))
    gram_s = gram * (scale[:, :, None] * scale[:, None, :])
    gram_s[:, n0 + 2] = 0
    gram_s[:, :, n0 + 2] = 0
    gram_s = gram_s.contiguous()
    eps = 4.0 * nk * 1.1920929e-07
    err = libs["cholesky"].gram_solve_launch(gram_s.data_ptr(), x.data_ptr(),
                                             bins, g, n0, nk, n0, eps, 1,
                                             None)
    assert err == 0
    ref = ch.solve_wpe_gram_plain(gram_s, n0, nk, n0, eps, equilibrate=True)
    assert torch.isfinite(x).all() and _rel(x, ref) < SOLVE_TOL
    if nk > 2:
        assert float(x[:, 2].abs().max()) == 0.0


@pytest.mark.parametrize("n,k", [(1, 1), (33, 6), (60, 6), (128, 8)])
def test_kernels_16_and_17_agree_to_the_bit(libs, n, k):
    """Kernels 16 and 17 run the same warp body on the same system, read
    in another layout: on the CPU, where neither fuses a multiply-add, the
    same bits.  Kernel 17 reads the system out of a Gram [b | a] at row0 =
    k."""
    rng = np.random.default_rng(n + 100 * k)
    bins = 7
    a = _gram(rng, bins, n, rank=n + 2, load=1.0)
    b = _cplx(rng, bins, n, k)
    gram = torch.zeros((bins, k + n, k + n), dtype=torch.complex64)
    gram[:, k:, k:] = a
    gram[:, k:, :k] = b
    gram = gram.contiguous()
    x16, x17 = torch.empty_like(b), torch.empty_like(b)
    lib = libs["cholesky"]
    assert lib.hermitian_solve_launch(a.data_ptr(), b.data_ptr(),
                                      x16.data_ptr(), bins, n, k, 1e-6, 0,
                                      None) == 0
    assert lib.gram_solve_launch(gram.data_ptr(), x17.data_ptr(), bins,
                                 k + n, k, n, k, 1e-6, 0, None) == 0
    assert torch.equal(x16, x17)
    assert _rel(x16, ch.hermitian_solve_lanes_plain(
        a, b, assume_hermitian=True)) < SOLVE_TOL


@pytest.fixture(scope="module")
def column_steps(tmp_path_factory):
    """cholesky.cu with chol_solve_warp's factorization a column a step."""
    return _emu_library("cholesky", tmp_path_factory.mktemp("columns"),
                        ["SETK_CHOL_PANEL=1"])


@pytest.mark.parametrize("n,k", [(1, 1), (5, 2), (33, 6), (60, 6), (127, 3),
                                 (128, 8)])
def test_panel_matches_column_steps_to_the_bit(libs, column_steps, n, k):
    """chol_solve_warp's factorization in panels of kCholPanel columns
    gives every entry the terms of a column a step, in the same order: on
    the CPU the same bits (n = 1 and 5 take single columns at the end,
    127 a last panel short of four)."""
    rng = np.random.default_rng(n + 7 * k)
    a = _gram(rng, 7, n, rank=n + 2, load=1.0)
    a = (a + 1e-3 * _cplx(rng, 7, n, n)).contiguous()
    b = _cplx(rng, 7, n, k)
    got, ref = torch.empty_like(b), torch.empty_like(b)
    for lib, x in ((libs["cholesky"], got), (column_steps, ref)):
        assert lib.hermitian_solve_launch(a.data_ptr(), b.data_ptr(),
                                          x.data_ptr(), 7, n, k, 1e-6, 1,
                                          None) == 0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,k,systems,nbytes", [(60, 6, 6, 18000),
                                                (128, 8, 3, 75264),
                                                (1, 1, 8, 32)])
def test_gram_solve_layout(libs, n, k, systems, nbytes):
    """Kernel 17's systems a block: the most an H100 SM (228 KB, 32
    blocks, 64 warps) holds, the larger count on a tie; none past 227 KB
    a system."""
    out = (ctypes.c_int * 2)()
    lib = libs["cholesky"]
    assert lib.gram_solve_layout(n, k, ctypes.addressof(out)) == 0
    assert tuple(out) == (systems, nbytes)
    for n_bad, k_bad in ((0, 1), (129, 1), (1, 0), (128, 2000)):
        assert lib.gram_solve_layout(n_bad, k_bad,
                                     ctypes.addressof(out)) != 0


@pytest.mark.parametrize("n,k,systems,nbytes", [(60, 6, 6, 17760),
                                                (128, 8, 3, 74752),
                                                (16, 1, 8, 1280)])
def test_hermitian_solve_layout(libs, n, k, systems, nbytes):
    """Kernel 16's systems a block, by kernel 17's rule, on systems
    without kernel 17's scales."""
    out = (ctypes.c_int * 2)()
    lib = libs["cholesky"]
    assert lib.hermitian_solve_layout(n, k, ctypes.addressof(out)) == 0
    assert tuple(out) == (systems, nbytes)
    for n_bad, k_bad in ((0, 1), (129, 1), (1, 0), (128, 2000)):
        assert lib.hermitian_solve_layout(n_bad, k_bad,
                                          ctypes.addressof(out)) != 0


# (N, taps, delay, context, T, use_g, external lambda): T past one and two
# 64-frame tiles, contexts 0-2, cols = 96 (300 of the 4 x 4 Gram blocks: two
# passes of 160 threads), taps reaching past the first tile.  Then: cols
# not a multiple of 4 (15, 18, 71); T = 1, 63, 64, 65 and 129 (a last tile
# of one frame); contexts 0-3; the WPE scene's cols = 66 (153 blocks, one
# pass of 160 threads); cols = 136 (595 blocks: three passes of 224
# threads, the last partly empty), with use_g and with external lambda;
# 71 taps of one mic, whose halo (74 frames) reaches past the previous
# tile; external lambda beside use_g (lambda wins); N = 7, so that every
# N of the dereverberation's instances runs
WPE_CASES = [(3, 4, 2, 1, 150, False, False), (3, 4, 2, 1, 150, True, False),
             (2, 3, 3, 2, 70, True, False), (1, 2, 0, 0, 64, True, False),
             (4, 2, 1, 0, 65, False, True), (8, 11, 3, 1, 40, True, False),
             (3, 5, 1, 3, 129, True, False), (2, 2, 2, 0, 1, True, False),
             (4, 3, 3, 2, 63, True, False), (5, 2, 3, 1, 64, False, False),
             (6, 10, 3, 1, 65, True, False), (8, 16, 3, 1, 70, True, False),
             (8, 16, 3, 0, 70, False, True), (1, 70, 3, 2, 150, True, False),
             (2, 6, 2, 1, 129, True, True), (7, 3, 2, 1, 100, True, False)]


@pytest.mark.parametrize("n,taps,delay,context,t,use_g,ext", WPE_CASES)
def test_wpe_gram_source_matches_plain(libs, n, taps, delay, context, t,
                                       use_g, ext):
    rng = np.random.default_rng(n * taps + t)
    bins, cols = 2, (taps + 1) * n
    obs = _cplx(rng, bins, n, t)
    obs[..., 5:] += 0.4 * obs[..., :-5]
    obs = obs.contiguous()
    g = (0.1 * _cplx(rng, bins, n * taps, n)).contiguous()
    lam = torch.from_numpy(rng.random((bins, t)).astype(np.float32) + 0.1)
    gram = torch.empty((bins, cols, cols), dtype=torch.complex64)
    err = libs["wpe_gram"].wpe_gram_launch(
        obs.data_ptr(), g.data_ptr(), lam.data_ptr() if ext else None,
        gram.data_ptr(), bins, n, t, taps, delay, context, int(use_g), None)
    assert err == 0
    ref = wg.wpe_gram_plain(obs, g, taps, delay, context, use_g,
                            lam if ext else None)
    assert _rel(gram, ref) < TOL
    assert torch.equal(gram, gram.conj().transpose(-1, -2))
    assert float(torch.diagonal(gram, dim1=-2, dim2=-1).imag.abs().max()) \
        == 0.0


def _apply_layout(lib, bins, n, t, taps, delay, sms):
    """Kernel 19's launch: (frames a tile, blocks, items a block, threads
    a block, blocks an SM, shared memory a block, window holds y)."""
    out = (ctypes.c_int * 7)()
    assert lib.wpe_apply_layout(bins, n, t, taps, delay, sms,
                                ctypes.addressof(out)) == 0
    return tuple(out)


# kernel 19: (N, taps, delay, T, bins, emulated SMs, offset), a block an
# SM (the emulator's occupancy).  Two bins on 6 SMs (a block an item) as
# before; every N of the template (1-8) at T = 600 and 8 bins on one SM
# (one block walks all 24 items through the ring, across bins); N taps =
# 128 (8 mics, taps 16); T = 1; T = 5 below delay + taps; T = 257, one
# past a tile; T = 301, odd, where lanes' second frames run past T; 15
# items on 2 SMs (8 and 7: a partial last block); delay past T; delay +
# taps - 1 past a tile, where y is read from device memory.  Offset 1:
# obs and G as views one complex word into their buffers (8 bytes past a
# 16-byte boundary, as a batch's `spec[1]` is where N T is odd), rows
# starting at either parity (N T odd; T odd, N T even; every row odd at
# T = 64, G of even size): a 16-byte copy from a misaligned address is
# the card's fault, and the emulator's.
WPE_APPLY = [pytest.param(n, taps, delay, t, 2, EMU_SMS, 0,
                          id=f"{n}-{taps}-{delay}-{t}")
             for n, taps, delay, t in ((3, 4, 2, 150), (6, 10, 3, 64),
                                       (1, 1, 0, 5))] + [
    pytest.param(n, 3, 2, 600, 8, 1, 0, id=f"n{n}-ring")
    for n in range(1, 9)] + [
    pytest.param(*c, 0, id="-".join(map(str, c)))
    for c in ((8, 16, 3, 300, 2, 1), (2, 3, 2, 1, 2, EMU_SMS),
              (3, 4, 3, 5, 2, EMU_SMS), (5, 2, 1, 257, 2, 1),
              (4, 5, 3, 301, 2, 1), (2, 3, 3, 1100, 3, 2),
              (2, 2, 40, 30, 2, EMU_SMS), (2, 3, 300, 700, 2, 1))] + [
    pytest.param(*c, 1, id="off-" + "-".join(map(str, c)))
    for c in ((3, 4, 2, 301, 3, 1), (6, 10, 3, 251, 2, 1),
              (1, 4, 1, 64, 2, 1))]


@pytest.mark.parametrize("n,taps,delay,t,bins,sms,off", WPE_APPLY)
def test_wpe_apply_source_matches_plain(libs, n, taps, delay, t, bins, sms,
                                        off):
    rng = np.random.default_rng(n + t)
    obs = _cplx(rng, bins * n * t + off)[off:].view(bins, n, t)
    g = (0.1 * _cplx(rng, bins * n * taps * n + off))[off:].view(
        bins, n * taps, n)
    assert obs.data_ptr() % 16 == 8 * off and g.data_ptr() % 16 == 8 * off
    out = torch.empty(obs.shape, dtype=obs.dtype)
    lib = libs["wpe_gram"]
    lib.emu_set_device_attributes(sms, EMU_SMEM)
    try:
        err = lib.wpe_apply_launch(obs.data_ptr(), g.data_ptr(),
                                   out.data_ptr(), bins, n, t, taps, delay,
                                   None)
    finally:
        lib.emu_set_device_attributes(EMU_SMS, EMU_SMEM)
    assert err == 0
    assert _rel(out, wg.wpe_apply_plain(obs, g, taps, delay)) < TOL


def test_wpe_apply_layout(libs):
    """Kernel 19's launch: one wave of blocks (the SMs times the blocks an
    SM holds; one here), items split evenly; the cases above take the ring
    across bins, a partial last block and y from device memory."""
    lib = libs["wpe_gram"]
    # a slot: G (27 complex, rounded up to even) and the window (3 rows of
    # 256 + 4 frames, one more for an odd start, rounded up to even)
    assert _apply_layout(lib, 8, 3, 600, 3, 2, 1) == (
        256, 1, 24, 128, 1, 2 * 8 * (28 + 3 * 262), 1)
    assert _apply_layout(lib, 3, 2, 1100, 3, 3, 2)[1:3] == (2, 8)
    assert _apply_layout(lib, 2, 3, 700, 3, 300, 1)[6] == 0
    # the WPE scene: 16,448 items over 132 SMs; a slot is G (60 x 6) and
    # the window (6 x 270)
    layout = _apply_layout(lib, 8224, 6, 501, 10, 3, 132)
    assert layout[1:3] == (132, 125) and layout[5] == 2 * 8 * (360 + 1620)
    out = (ctypes.c_int * 7)()
    for bins, n, t, taps, delay, sms in ((0, 2, 5, 2, 1, 1),
                                         (1, 9, 5, 2, 1, 1),
                                         (1, 2, 0, 2, 1, 1),
                                         (1, 2, 5, 2, -1, 1),
                                         (1, 2, 5, 2, 1, 0)):
        assert lib.wpe_apply_layout(bins, n, t, taps, delay, sms,
                                    ctypes.addressof(out)) != 0


def test_wpe_entry_points_reject_bad_arguments(libs):
    p = torch.zeros(8).data_ptr()
    lib = libs["cholesky"]
    for bins, n, k in ((0, 4, 1), (1, 0, 1), (1, 129, 1), (1, 4, 0),
                       (1, 128, 2000)):
        assert lib.hermitian_solve_launch(p, p, p, bins, n, k, 1e-6, 1,
                                          None) != 0
    for bins, g, row0, n, k in ((0, 8, 2, 4, 2), (1, 8, 5, 4, 2),
                                (1, 8, -1, 4, 2), (1, 8, 2, 4, 9),
                                (1, 200, 2, 129, 2)):
        assert lib.gram_solve_launch(p, p, bins, g, row0, n, k, 1e-6, 0,
                                     None) != 0
    lib = libs["wpe_gram"]
    for bins, n, t, taps, delay, ctx in ((0, 2, 8, 2, 1, 1), (1, 9, 8, 2, 1,
                                                              1),
                                         (1, 8, 8, 17, 1, 1),
                                         (1, 2, 0, 2, 1, 1),
                                         (1, 2, 8, 2, -1, 1),
                                         (1, 2, 8, 2, 1, -1)):
        assert lib.wpe_gram_launch(p, p, None, p, bins, n, t, taps, delay,
                                   ctx, 1, None) != 0
        assert ctx < 0 or lib.wpe_apply_launch(p, p, p, bins, n, t, taps,
                                               delay, None) != 0
    # use_g needs G unless lambda is given
    assert lib.wpe_gram_launch(p, None, None, p, 1, 2, 8, 2, 1, 1, 1,
                               None) != 0


# kernels 20-21: (T, B, H, weight type); B = 5, 6 and 9 leave the last tile
# of 4 batch rows ragged, T = 1 is a single step
LSTM = [(1, 3, 32, "float32"), (1, 5, 32, "bfloat16"),
        (7, 6, 64, "float32"), (7, 6, 64, "bfloat16"),
        (5, 9, 40, "bfloat16")]
# of the peak; f32: TOL, sums in another order; bf16: where two f32 sums
# round h (or dgates) to bf16 on either side of a rounding boundary the
# operand moves by one bf16 step, 2^-8 of itself
LSTM_TOL = {"float32": TOL, "bfloat16": 2e-3}


def _lstm_inputs(t, b, h, dtype, seed):
    rng = np.random.default_rng(seed)
    xg = [torch.from_numpy(rng.standard_normal((t, b, 4 * h)).astype(
        np.float32) * 0.5) for _ in "fb"]
    wh = [torch.from_numpy((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                           .astype(np.float32)).to(getattr(torch, dtype))
          for _ in "fb"]
    return xg, wh, rng


# kernel 20's two variants over LSTM and, for the resident one on the
# emulated 3 blocks a direction, cases of its own: H = 32, 40 and 64 leave
# the last block's unit slice ragged (11, 14 and 22 units a block); H = 2
# leaves a block of each direction idle at every barrier; B = 90 at H =
# 150 (50 units a block) takes three h tiles of at most 40 rows; T = 1
# with B = 1; B = 1, 2, 3 and 4 rows hold 1, 2, 4 and 4 of a thread's 8
# row slots
RESIDENT = [(4, 3, 2, "float32"), (4, 3, 2, "bfloat16"),
            (3, 2, 24, "float32"), (5, 4, 36, "bfloat16"),
            (3, 90, 150, "float32"), (3, 90, 150, "bfloat16"),
            (1, 1, 32, "float32"), (1, 1, 32, "bfloat16")]
LSTM_FWD = [pytest.param("stream", *c, id="-".join(map(str, c)))
            for c in LSTM] + \
    [pytest.param(v, *c, id="-".join(map(str, (v,) + c)))
     for v in ("resident", "stream") for c in RESIDENT] + \
    [pytest.param("resident", *c, id="-".join(map(str, ("resident",) + c)))
     for c in LSTM]


@pytest.mark.parametrize("variant,t,b,h,dtype", LSTM_FWD)
def test_lstm_fwd_source_matches_plain(libs, variant, t, b, h, dtype):
    (xgf, xgb), (whf, whb), _ = _lstm_inputs(t, b, h, dtype, t * b + h)
    out = [torch.empty((t, b, h)) for _ in range(4)]
    size = 2 if dtype == "bfloat16" else 4
    if variant == "resident":
        assert ls.resident_layout(b, h, size, EMU_SMS, EMU_SMEM)
    err = getattr(libs["lstm_seq"], f"lstm_fwd_{variant}_launch")(
        xgf.data_ptr(), xgb.data_ptr(), whf.data_ptr(), whb.data_ptr(),
        *(o.data_ptr() for o in out), t, b, h, int(dtype == "bfloat16"),
        None)
    assert err == 0
    ref = ls.lstm_seq_forward_plain(xgf, xgb, whf, whb)
    for got, want in zip(out, ref):
        assert _rel(got, want) < LSTM_TOL[dtype]


def _lstm_bwd_case(t, b, h, dtype, seed):
    """Kernel 21's inputs from the plain forward's states, numpy-made."""
    (xgf, xgb), (whf, whb), rng = _lstm_inputs(t, b, h, dtype, seed)
    ysf, csf, ysb, csb = ls.lstm_seq_forward_plain(xgf, xgb, whf, whb)
    dyf, dyb = (torch.from_numpy(rng.standard_normal((t, b, h)).astype(
        np.float32)) for _ in "fb")
    return (dyf, dyb, xgf, xgb, ysf, ysb, csf, csb, whf, whb)


def _check_bwd(args, dxf, dxb, dtype):
    rf, rb = ls.lstm_seq_backward_plain(*args)
    assert _rel(dxf, rf) < LSTM_TOL[dtype]
    assert _rel(dxb, rb) < LSTM_TOL[dtype]


@pytest.mark.parametrize("t,b,h,dtype", LSTM)
def test_lstm_bwd_source_matches_plain(libs, t, b, h, dtype):
    """Kernel 21's stream variant."""
    args = _lstm_bwd_case(t, b, h, dtype, t + b * h)
    whf, whb = args[-2:]
    wtf, wtb = whf.t().contiguous(), whb.t().contiguous()
    dxf, dxb = torch.empty_like(args[2]), torch.empty_like(args[3])
    err = libs["lstm_seq"].lstm_bwd_stream_launch(
        *(x.data_ptr() for x in args + (wtf, wtb, dxf, dxb)), t, b, h,
        int(dtype == "bfloat16"), None)
    assert err == 0
    _check_bwd(args, dxf, dxb, dtype)


# kernel 21's resident variant at every (T, B, H) of RESIDENT and LSTM, in
# f32 and bf16; on the emulated card H = 150 at B = 90 takes phase-1 tiles
# of 32 rows over (t, b) and two (bf16) or three (f32) dgates chunks; B =
# 130 at H = 200 (bf16, 67 units a block) two batch tiles of 120 rows and
# five chunks a step; an odd H = 33 reads bf16 dgates 4 at a time
LSTM_BWD_SHAPES = sorted({c[:3] for c in RESIDENT + LSTM}) + [
    (2, 130, 200), (3, 5, 33)]
LSTM_BWD = [pytest.param(*c, d, id="-".join(map(str, c + (d,))))
            for c in LSTM_BWD_SHAPES for d in ("float32", "bfloat16")
            if ls.backward_resident_layout(c[1], c[2], 4 if d == "float32"
                                           else 2, EMU_SMS, EMU_SMEM)]


def test_lstm_bwd_cases_cover_the_layout():
    """The resident cases reach what the kernel's layout branches on: every
    shape but f32 at H = 200 fits the emulated card; several dgates chunks
    (H = 150) and batch tiles with chunks (B = 130); an idle block (H = 2:
    one unit a block, 3 blocks a direction)."""
    def lay(b, h, size):
        return ls.backward_resident_layout(b, h, size, EMU_SMS, EMU_SMEM)
    assert len(LSTM_BWD) == 2 * len(LSTM_BWD_SHAPES) - 1
    assert lay(90, 150, 4)[5] < 600 and lay(90, 150, 2)[5] < 600
    assert lay(130, 200, 2)[4] < 130 and lay(130, 200, 2)[5] < 800
    assert lay(3, 2, 4)[:2] == (3, 1)


@pytest.mark.parametrize("t,b,h,dtype", LSTM_BWD)
def test_lstm_bwd_resident_source_matches_plain(libs, t, b, h, dtype):
    args = _lstm_bwd_case(t, b, h, dtype, t + b * h)
    dxf, dxb = torch.empty_like(args[2]), torch.empty_like(args[3])
    ex = [torch.empty((2, b, 4 * h), dtype=getattr(torch, dtype))
          for _ in "fb"]
    err = libs["lstm_seq"].lstm_bwd_resident_launch(
        *(x.data_ptr() for x in args + (*ex, dxf, dxb)), t, b, h,
        int(dtype == "bfloat16"), None)
    assert err == 0
    _check_bwd(args, dxf, dxb, dtype)


def test_lstm_entry_points_reject_bad_shapes(libs):
    p = torch.zeros(8).data_ptr()
    lib = libs["lstm_seq"]
    for t, b, h in ((0, 2, 8), (2, 0, 8), (2, 2, 0), (2, 2, 1025)):
        assert lib.lstm_fwd_stream_launch(*[p] * 8, t, b, h, 0, None) != 0
        assert lib.lstm_fwd_resident_launch(*[p] * 8, t, b, h, 0,
                                            None) != 0
        assert lib.lstm_bwd_stream_launch(*[p] * 14, t, b, h, 1,
                                          None) != 0
        assert lib.lstm_bwd_resident_launch(*[p] * 14, t, b, h, 1,
                                            None) != 0
    # inside the gate, but the resident layout does not fit the emulated
    # card (more than 256 units a block; a W_h slice beyond its shared
    # memory): the resident entry refuses before launching
    for b, h, bf16 in ((2, 1024, 0), (2, 1024, 1), (2, 700, 0)):
        assert ls.resident_layout(b, h, 2 if bf16 else 4, EMU_SMS,
                                  EMU_SMEM) is None
        assert lib.lstm_fwd_resident_launch(*[p] * 8, 2, b, h, bf16,
                                            None) != 0
    # kernel 21's: those, and f32 at H = 200 (67 units, a 218 KB row
    # slice), bf16 at H = 300 (a 240 KB slice), and a dc carry of B = 2000
    # rows at H = 150 beside the bf16 slices
    for b, h, bf16 in ((2, 1024, 0), (2, 1024, 1), (2, 700, 0),
                       (2, 200, 0), (2, 300, 1), (2000, 150, 1)):
        assert ls.backward_resident_layout(b, h, 2 if bf16 else 4, EMU_SMS,
                                           EMU_SMEM) is None
        assert lib.lstm_bwd_resident_launch(*[p] * 14, 2, b, h, bf16,
                                            None) != 0


def test_lstm_device_limits_read_the_card(libs):
    out = (ctypes.c_int * 2)()
    assert libs["lstm_seq"].lstm_device_limits(ctypes.addressof(out)) == 0
    assert tuple(out) == (EMU_SMS, EMU_SMEM)


@pytest.mark.parametrize("h,dtype,want", [
    (1024, torch.bfloat16, "resident"), (512, torch.float32, "resident"),
    (1024, torch.float32, "stream"), (891, torch.float32, "resident"),
    (892, torch.float32, "stream"), (512, torch.bfloat16, "resident")])
def test_lstm_forward_variant_on_an_h100(h, dtype, want):
    """132 SMs, 227 KB a block: every bf16 H <= 1024 and f32 up to H = 891
    run resident, at any B; one h tile holds all 64 bench rows at H =
    512."""
    for b in (1, 64, 1000):
        assert ls.forward_variant(b, h, dtype, 132, 232448) == want
    assert ls.resident_layout(64, 512, 2, 132, 232448) == (
        66, 8, 516, 64, 32768 + 64 * 516 * 4)
    # H = 1024: 16 units, a 128 KB slice, tiles of 24 rows
    assert ls.resident_layout(64, 1024, 2, 132, 232448)[1:4] == (16, 1028,
                                                                 24)


@pytest.mark.parametrize("b,h,size,sms,smem", [
    (64, 512, 2, 132, 232448), (64, 1024, 2, 132, 232448),
    (64, 512, 4, 132, 232448), (64, 792, 4, 132, 232448),
    (64, 793, 4, 132, 232448), (1, 8, 2, 132, 232448),
    (1000, 1024, 2, 132, 232448), (1100, 1024, 2, 132, 232448),
    (90, 150, 4, EMU_SMS, EMU_SMEM), (130, 200, 2, EMU_SMS, EMU_SMEM),
    (3, 2, 4, EMU_SMS, EMU_SMEM), (7, 100, 2, 2, 49152),
    (5, 64, 2, 1, 232448)])
def test_lstm_bwd_layouts_agree(libs, b, h, size, sms, smem):
    """csrc/lstm_seq.cu's bwd_resident_layout (through lstm_bwd_layout)
    and backward_resident_layout: the same layout, or both none."""
    out = (ctypes.c_int * 8)()
    err = libs["lstm_seq"].lstm_bwd_layout(b, h, size, sms, smem,
                                           ctypes.addressof(out))
    want = ls.backward_resident_layout(b, h, size, sms, smem)
    assert (tuple(out) if err == 0 else None) == want


@pytest.mark.parametrize("h,dtype,want", [
    (1024, torch.bfloat16, "resident"), (512, torch.float32, "resident"),
    (792, torch.float32, "resident"), (793, torch.float32, "stream"),
    (1024, torch.float32, "stream"), (512, torch.bfloat16, "resident")])
def test_lstm_backward_variant_on_an_h100(h, dtype, want):
    """132 SMs, 227 KB a block: every bf16 H <= 1024 and f32 up to H = 792
    run kernel 21 resident at B = 1 and 64 (the row slice takes whole
    groups of 4 units: f32 at H = 793 has 13 units a block, a 203 KB
    slice); at the bench shape the dgates are read in three chunks of up
    to 688 columns, widened into an f32 tile."""
    for b in (1, 64):
        assert ls.backward_variant(b, h, dtype, 132, 232448) == want
    assert ls.backward_resident_layout(64, 512, 2, 132, 232448) == (
        66, 8, 64, 516, 64, 688, 692, 32768 + 2048 + 64 * 692 * 4)
    # H = 1024: 16 units, a 128 KB slice, phase-1 tiles of 16 rows, twelve
    # chunks of up to 344 columns; the dc carry sends B above 1072 to the
    # stream variant
    assert ls.backward_resident_layout(64, 1024, 2, 132, 232448)[1:7] == (
        16, 16, 1028, 64, 344, 348)
    assert ls.backward_variant(1072, 1024, torch.bfloat16, 132,
                               232448) == "resident"
    assert ls.backward_variant(1073, 1024, torch.bfloat16, 132,
                               232448) == "stream"


@pytest.fixture
def meta_card(monkeypatch):
    """Meta tensors stand for card tensors: the wrappers check and
    allocate as on the card and record the entry point they call."""
    calls = []
    monkeypatch.setattr(ls, "device_limits", lambda dev: (132, 232448))
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: calls.append(fn))
    for fn in (ls.lstm_seq_forward, ls.lstm_seq_forward_resident,
               ls.lstm_seq_forward_stream, ls.lstm_seq_backward,
               ls.lstm_seq_backward_resident, ls.lstm_seq_backward_stream):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


@pytest.mark.parametrize("h,dtype,entry", [
    (512, torch.bfloat16, "lstm_fwd_resident_launch"),
    (1024, torch.float32, "lstm_fwd_stream_launch")])
def test_lstm_forward_dispatch_counts_each_variant(meta_card, h, dtype,
                                                   entry):
    xg = [torch.empty((3, 5, 4 * h), device="meta") for _ in "fb"]
    wh = [torch.empty((h, 4 * h), dtype=dtype, device="meta") for _ in "fb"]
    out = ls.lstm_seq_forward(*xg, *wh)
    assert meta_card == [entry]
    assert [tuple(o.shape) for o in out] == [(3, 5, h)] * 4
    resident = entry == "lstm_fwd_resident_launch"
    assert (ls.lstm_seq_forward.launches,
            ls.lstm_seq_forward_resident.launches,
            ls.lstm_seq_forward_stream.launches) == (1, int(resident),
                                                     int(not resident))


def test_lstm_forward_failed_launch_raises(meta_card, monkeypatch):
    """A resident launch that fails raises; the stream variant is not
    tried and nothing is counted."""
    def refuse(name, fn, dev, *args):
        meta_card.append(fn)
        _build.check(720, fn)
    monkeypatch.setattr(_build, "launch", refuse)
    xg = [torch.empty((3, 5, 64), device="meta") for _ in "fb"]
    wh = [torch.empty((16, 64), dtype=torch.bfloat16, device="meta")
          for _ in "fb"]
    with pytest.raises(RuntimeError, match="lstm_fwd_resident_launch"):
        ls.lstm_seq_forward(*xg, *wh)
    assert meta_card == ["lstm_fwd_resident_launch"]
    assert (ls.lstm_seq_forward.launches,
            ls.lstm_seq_forward_resident.launches,
            ls.lstm_seq_forward_stream.launches) == (0, 0, 0)


def _meta_bwd_args(t, b, h, dtype):
    seq = [torch.empty((t, b, h), device="meta") for _ in range(2)]
    xg = [torch.empty((t, b, 4 * h), device="meta") for _ in "fb"]
    st = [torch.empty((t, b, h), device="meta") for _ in range(4)]
    wh = [torch.empty((h, 4 * h), dtype=dtype, device="meta") for _ in "fb"]
    return (*seq, *xg, *st, *wh)


def _bwd_launches():
    return (ls.lstm_seq_backward.launches,
            ls.lstm_seq_backward_resident.launches,
            ls.lstm_seq_backward_stream.launches)


@pytest.mark.parametrize("h,dtype,entry", [
    (512, torch.bfloat16, "lstm_bwd_resident_launch"),
    (512, torch.float32, "lstm_bwd_resident_launch"),
    (1024, torch.float32, "lstm_bwd_stream_launch")])
def test_lstm_backward_dispatch_counts_each_variant(meta_card, h, dtype,
                                                    entry):
    out = ls.lstm_seq_backward(*_meta_bwd_args(3, 5, h, dtype))
    assert meta_card == [entry]
    assert [tuple(o.shape) for o in out] == [(3, 5, 4 * h)] * 2
    resident = entry == "lstm_bwd_resident_launch"
    assert _bwd_launches() == (1, int(resident), int(not resident))
    # each variant's own entry point launches it alone, whatever the gate
    # would pick, and counts in its own wrapper only
    ls.lstm_seq_backward_stream(*_meta_bwd_args(2, 1, 8, torch.bfloat16))
    assert meta_card[1:] == ["lstm_bwd_stream_launch"]
    assert _bwd_launches() == (1, int(resident), int(not resident) + 1)


def test_lstm_backward_failed_launch_raises(meta_card, monkeypatch):
    """A resident launch that fails raises; the stream variant is not
    tried and nothing is counted."""
    def refuse(name, fn, dev, *args):
        meta_card.append(fn)
        _build.check(720, fn)
    monkeypatch.setattr(_build, "launch", refuse)
    with pytest.raises(RuntimeError, match="lstm_bwd_resident_launch"):
        ls.lstm_seq_backward(*_meta_bwd_args(3, 5, 16, torch.bfloat16))
    assert meta_card == ["lstm_bwd_resident_launch"]
    assert _bwd_launches() == (0, 0, 0)


def test_library_names_follow_sources_and_headers(tmp_path, monkeypatch):
    """A library is named by its source and the csrc headers it includes:
    editing jacobi.cuh renames the Jacobi and EM libraries, and only
    those."""
    for src in _build.SOURCE_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    before = {name: _build._target(name).name for name in _build.SOURCES}
    header = tmp_path / "jacobi.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(name).name for name in _build.SOURCES}
    assert {name for name in before if before[name] != after[name]} == {
        "eigh_small", "cacgmm_em"}
