"""The CUDA kernel sources of setk_tpu_torch, run on the CPU.

The sources under setk_tpu_torch/csrc compile with the host C++ compiler
against tests/cuda_emu/cuda_runtime.h, a CPU stand-in for the CUDA
runtime (blocks in order, a block's threads as std::threads with a
barrier), and run through their C entry points on CPU tensors.  This
checks the kernels' index arithmetic, FFT, reductions and overlap-add
against their plain PyTorch versions without a card; it says nothing of
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
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv

EMU = Path(__file__).resolve().parent / "cuda_emu"
TOL = 1e-5   # f32 radix-2 FFT against pocketfft, f32 sums in another order
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
    assert libs["mvdr_power"].mvdr_power_launch(
        z.data_ptr(), z.data_ptr(), z.data_ptr(), 4, 9, 15, 1e-6, None) != 0
