"""Loader for the native wav decoder (``native/wav_io.cc``).

The port's counterpart of ``setk_tpu/utils/native.py``.  It compiles
``native/wav_io.cc`` alone with the host C++ compiler
(``-O3 -shared -fPIC -pthread``, no cmake) into
``setk_tpu_torch/_build/``, named by a hash of the source and the flags,
and binds it through its C ABI (``io/native_wav.py``).  Nothing is built
at import: the first call of ``load_native`` builds.  A failed build is
remembered, so callers fall back to the Python decoder once, not per
call.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_native", "native_available", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "wav_io.cc"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_LIB = None
_LIB_ERR = None


def _compiler() -> str:
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++, g++ or clang++) found")


def _build() -> Path:
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libwav_io-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_native() -> ctypes.CDLL:
    """Load (building if needed) the native wav library; raises on
    failure, and again on every later call without rebuilding."""
    global _LIB, _LIB_ERR
    with _lock:
        if _LIB is not None:
            return _LIB
        if _LIB_ERR is not None:
            raise _LIB_ERR
        try:
            _LIB = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as exc:
            _LIB_ERR = exc
            raise
        return _LIB


def native_available() -> bool:
    try:
        load_native()
        return True
    except (OSError, RuntimeError):
        return False
