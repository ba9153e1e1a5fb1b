"""ctypes bindings for the native wav decoder/batch loader.

The port's copy of setk_tpu/io/native_wav.py: single-file decode plus a
threaded batch decode that fills a pre-allocated padded (B, C, S) bucket
buffer in one call, through the C ABI of native/wav_io.cc (built by
utils/native.py).  Python parity oracle: io/wave.py.
"""

import ctypes
import os

import numpy as np

from setk_tpu_torch.utils.native import load_native, native_available

__all__ = ["native_available", "read_wav_native", "wav_info_native",
           "batch_read_into", "write_wav_native"]

_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)

_ERRORS = {
    -1: "cannot open file",
    -2: "not a RIFF/WAVE file",
    -3: "no data chunk",
    -4: "unsupported encoding",
    -5: "short read/write",
    -6: "output buffer too small",
}


def _lib():
    lib = load_native()
    if not getattr(lib, "_wav_io_ready", False):
        lib.wav_io_info.restype = ctypes.c_int64
        lib.wav_io_read.restype = ctypes.c_int
        lib.wav_io_batch_read.restype = ctypes.c_int
        lib.wav_io_write.restype = ctypes.c_int
        lib._wav_io_ready = True
    return lib


def _check(rc, path=""):
    if rc < 0:
        raise RuntimeError(
            f"native wav IO: {_ERRORS.get(rc, f'error {rc}')} ({path})")


def wav_info_native(path):
    """(num_channels, sample_rate, num_frames) from the header only."""
    lib = _lib()
    ch, sr = ctypes.c_int32(), ctypes.c_int32()
    bits, fmt = ctypes.c_int32(), ctypes.c_int32()
    frames = lib.wav_io_info(os.fsencode(str(path)), ctypes.byref(ch),
                             ctypes.byref(sr), ctypes.byref(bits),
                             ctypes.byref(fmt))
    _check(frames, path)
    return ch.value, sr.value, frames


def read_wav_native(path, beg=0, end=None, normalize=True, sr=16000):
    """Native drop-in for io.wave.read_wav on plain file paths."""
    lib = _lib()
    channels, ret_sr, total = wav_info_native(path)
    if sr is not None and sr != ret_sr:
        raise RuntimeError(f"Expect sr={sr} of {path}, get {ret_sr} instead")
    beg = int(beg or 0)
    stop = total if end is None else min(int(end), total)
    frames = max(stop - beg, 0)
    out = np.empty((channels, frames), dtype=np.float32)
    ch = ctypes.c_int32()
    got = ctypes.c_int64()
    rc = lib.wav_io_read(os.fsencode(str(path)), ctypes.c_int64(beg),
                         ctypes.c_int64(stop), ctypes.c_int(int(normalize)),
                         out.ctypes.data_as(_c_f32p),
                         ctypes.c_int64(frames), ctypes.c_int32(channels),
                         ctypes.byref(ch), ctypes.byref(got))
    _check(rc, path)
    return out[0] if channels == 1 else out


def batch_read_into(paths, out, offsets, chan_stride=None, max_channels=0,
                    begs=None, ends=None, normalize=True, num_threads=None):
    """Decode many files into one padded buffer with a thread pool.

    ``out`` is a C-contiguous float32 array (pre-zeroed for padding);
    job i decodes ``paths[i]`` channel-first at flat offset
    ``offsets[i]``, its channels ``chan_stride`` floats apart — a scalar
    or a per-job array (default: ``out.shape[-1]``, right for a
    (..., C, S) batch buffer).  ``max_channels`` > 0 rejects files with
    more channels than the buffer row allows.  Returns
    (channels, frames) int arrays per job.
    """
    lib = _lib()
    n = len(paths)
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous float32")
    if chan_stride is None:
        chan_stride = out.shape[-1]
    chan_strides = np.ascontiguousarray(
        np.broadcast_to(np.asarray(chan_stride, dtype=np.int64), (n,)))
    arr_t = ctypes.c_char_p * n
    c_paths = arr_t(*[os.fsencode(str(p)) for p in paths])
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    begs = (np.ascontiguousarray(begs, dtype=np.int64)
            if begs is not None else None)
    ends = (np.ascontiguousarray(ends, dtype=np.int64)
            if ends is not None else None)
    channels = np.zeros(n, dtype=np.int32)
    frames = np.zeros(n, dtype=np.int64)
    if num_threads is None:
        num_threads = min(max(os.cpu_count() or 1, 1), 16)
    rc = lib.wav_io_batch_read(
        c_paths, ctypes.c_int32(n),
        begs.ctypes.data_as(_c_i64p) if begs is not None else None,
        ends.ctypes.data_as(_c_i64p) if ends is not None else None,
        ctypes.c_int(int(normalize)), out.ctypes.data_as(_c_f32p),
        offsets.ctypes.data_as(_c_i64p),
        chan_strides.ctypes.data_as(_c_i64p),
        ctypes.c_int32(int(max_channels)), ctypes.c_int32(num_threads),
        channels.ctypes.data_as(_c_i32p), frames.ctypes.data_as(_c_i64p))
    _check(rc)
    return channels, frames


def write_wav_native(path, samps, sr=16000, normalize=True):
    """Native PCM16 writer matching io.wave.write_wav semantics."""
    lib = _lib()
    samps = np.asarray(samps, dtype=np.float32)
    if samps.ndim != 1 and samps.shape[0] < samps.shape[1]:
        pass  # already channel-first
    elif samps.ndim != 1:
        samps = samps.T
    samps = np.ascontiguousarray(np.atleast_2d(samps), dtype=np.float32)
    channels, frames = samps.shape
    d = os.path.dirname(str(path))
    if d and not os.path.exists(d):
        os.makedirs(d, exist_ok=True)
    rc = lib.wav_io_write(os.fsencode(str(path)),
                          samps.ctypes.data_as(_c_f32p),
                          ctypes.c_int64(frames), ctypes.c_int32(channels),
                          ctypes.c_int32(sr), ctypes.c_int(int(normalize)))
    _check(rc, path)
