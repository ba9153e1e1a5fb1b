"""Build and load the port's CUDA kernels.

Each source under ``setk_tpu_torch/csrc/`` compiles with ``nvcc`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries are named by a hash of their source, the headers under
``csrc/`` that it includes (``#include "..."``, followed through the
headers) and the flags, so an edited source or header rebuilds and an
unchanged one loads as built.  The
build directory (``setk_tpu_torch/_build/``) is not committed.  Nothing
here runs at import: the first kernel launch builds its library, and
``build_all`` builds every library at once, one ``nvcc`` per source.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "library", "check",
           "launch"]

_PKG = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"mvdr_power": "mvdr_power.cu", "fused_mvdr": "fused_mvdr.cu",
           "planar_stft": "planar_stft.cu",
           "covariance_pair": "covariance_pair.cu",
           "covariance": "covariance.cu", "eigh_small": "eigh_small.cu",
           "cacgmm_em": "cacgmm_em.cu", "cholesky": "cholesky.cu",
           "wpe_gram": "wpe_gram.cu", "lstm_seq": "lstm_seq.cu",
           "omlsa": "omlsa.cu"}
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source beside _FLAGS: the OM-LSA recursion rounds every
# product and sum as its plain version's separate PyTorch launches do
# (csrc/omlsa.cu's note)
_SOURCE_FLAGS = {"omlsa": ["-fmad=false"]}

# C entry points and their ctypes signatures
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
_SIGNATURES = {
    "mvdr_power": {
        "mvdr_power_launch": [_P, _P, _P, _I, _I, _I, _F, _P],
        "gevd_power_launch": [_P, _P, _P, _I, _I, _I, _F, _P],
        "pmwf_solve_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
        "capon_launch": [_P, _P, _P, _I, _I, _F, _P],
    },
    "fused_mvdr": {
        "stft_covar_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P],
        "beamform_istft_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P],
        "stft_covar_chunks_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P],
        "covar_ema_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        "beamform_istft_online_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _P],
        "stft_covar_layout": [_I, _I, _P],
        "stft_covar_transform_launch": [_P, _P, _I, _P],
        "beamform_istft_layout": [_I, _I, _I, _I, _I, _P],
        "beamform_istft_inverse_launch": [_P, _P, _I, _P],
    },
    "planar_stft": {
        "stft_planar_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "istft_planar_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P],
        "stft_planar_transform_launch": [_P, _P, _I, _I, _P],
        "beamform_istft_planar_launch": [_P] * 7 + [_I] * 6 + [_P],
        "istft_planar_inverse_launch": [_P, _P, _I, _I, _P],
        "istft_planar_layout": [_I, _I, _P],
    },
    "covariance_pair": {
        "pair_covar_launch": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _P],
    },
    "covariance": {
        "masked_covar_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "eigh_small": {
        "regularized_inverse_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
        "regularized_inverse_pick": [_I, _I],
        "hermitian_eigh_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
        "hermitian_eigh_form_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _I,
                                       _P],
        "hermitian_eigh_pick": [_I, _I],
    },
    "cacgmm_em": {
        "cacgmm_em_launch": [_P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "cacgmm_em_layout": [_I, _I, _P],
        "warp_jacobi_launch": [_P, _P, _P, _I, _I, _I, _P],
    },
    "cholesky": {
        "hermitian_solve_launch": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
        "gram_solve_launch": [_P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "gram_solve_layout": [_I, _I, _P],
        "hermitian_solve_layout": [_I, _I, _P],
    },
    "wpe_gram": {
        "wpe_gram_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "wpe_apply_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "wpe_apply_layout": [_I] * 6 + [_P],
    },
    "lstm_seq": {
        "lstm_fwd_stream_launch": [_P] * 8 + [_I] * 4 + [_P],
        "lstm_fwd_resident_launch": [_P] * 8 + [_I] * 4 + [_P],
        "lstm_device_limits": [_P],
        "lstm_bwd_stream_launch": [_P] * 14 + [_I] * 4 + [_P],
        "lstm_bwd_resident_launch": [_P] * 14 + [_I] * 4 + [_P],
        "lstm_bwd_layout": [_I] * 5 + [_P],
    },
    "omlsa": {
        "omlsa_launch": [_P] * 6 + [_I, _I, _P],
        "omlsa_layout": [_I] * 4 + [_P],
        "omlsa_div_launch": [_P] * 4 + [_L, _P],
    },
}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_lock = threading.Lock()
_loaded = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _included(path: Path, seen: set) -> list:
    """``path`` and the csrc headers it includes, depth first, each once."""
    if path in seen:
        return []
    seen.add(path)
    files = [path]
    for header in _INCLUDE.findall(path.read_text()):
        if (SOURCE_DIR / header).is_file():
            files += _included(SOURCE_DIR / header, seen)
    return files


def _flags(name: str) -> list:
    return _FLAGS + _SOURCE_FLAGS.get(name, [])


def _target(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in _included(SOURCE_DIR / SOURCES[name], set()):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
           str(SOURCE_DIR / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every kernel library in parallel; returns nvcc's log
    (registers, shared memory and spills from ``-Xptxas -v``) per
    library, empty for one that was already built."""
    with _lock:
        jobs = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, job) for name, job in jobs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch(name: str, fn: str, device, *args) -> None:
    """Call C entry point ``fn`` of library ``name`` on ``device``'s
    current stream; raise on a non-zero cudaError_t."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(name), fn)(*args, stream)
    check(err, fn)
