"""Wave IO without external audio deps; channel-first layout.

Parity: reference scripts/sptk/libs/utils.py:45-92 (which uses
soundfile) — reads return ``C x N`` (or ``N`` for mono) float32 in [-1, 1]
when normalized; writes accept either layout.  Implemented on the stdlib
``wave``/``struct`` plus numpy so it works on raw streams (wav-ark offset
reads) as well as paths; PCM16/PCM24/PCM32/float32 encodings supported.

The port's own copy of setk_tpu/io/wave.py (numpy only).
"""

import os
import struct

import numpy as np

__all__ = ["read_wav", "write_wav", "wav_duration", "wav_info"]

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXT = 0xFFFE


def _parse_header(fd):
    """Parse a RIFF/WAVE header from the current stream position.

    Returns (num_channels, sample_rate, bits, fmt_code, data_offset,
    data_bytes); the stream is left positioned at the start of data.
    """
    riff = fd.read(4)
    if riff != b"RIFF":
        raise RuntimeError(f"Not a RIFF file (got {riff!r})")
    fd.read(4)  # total size
    if fd.read(4) != b"WAVE":
        raise RuntimeError("Not a WAVE file")
    fmt_code = channels = sr = bits = None
    while True:
        hdr = fd.read(8)
        if len(hdr) < 8:
            raise RuntimeError("No data chunk found")
        chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if chunk_id == b"fmt ":
            fmt = fd.read(size)
            fmt_code, channels, sr = struct.unpack("<HHI", fmt[:8])
            bits = struct.unpack("<H", fmt[14:16])[0]
            if fmt_code == _FMT_EXT and size >= 40:
                # sub-format GUID leads with the actual format code
                fmt_code = struct.unpack("<H", fmt[24:26])[0]
        elif chunk_id == b"data":
            return channels, sr, bits, fmt_code, size
        else:
            fd.seek(size + (size & 1), 1)


def _decode(raw, bits, fmt_code, channels, normalize):
    if fmt_code == _FMT_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        samps = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif bits == 16:
        samps = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        if normalize:
            samps = samps / 32768.0
    elif bits == 32:
        samps = np.frombuffer(raw, dtype="<i4").astype(np.float32)
        if normalize:
            samps = samps / 2147483648.0
    elif bits == 8:
        samps = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
        if normalize:
            samps = samps / 128.0
    elif bits == 24:
        u8 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (u8[:, 0].astype(np.int32) | (u8[:, 1].astype(np.int32) << 8) |
               (u8[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        samps = val.astype(np.float32)
        if normalize:
            samps = samps / float(1 << 23)
    else:
        raise RuntimeError(f"Unsupported wav encoding: fmt={fmt_code} "
                           f"bits={bits}")
    if channels > 1:
        samps = samps.reshape(-1, channels)
    return samps


def read_wav(fname, beg=0, end=None, normalize=True, sr=16000):
    """Read (a chunk of) a wav file or stream -> channel-first samples."""
    own = not hasattr(fname, "read")
    fd = open(fname, "rb") if own else fname
    try:
        channels, ret_sr, bits, fmt_code, data_bytes = _parse_header(fd)
        if sr is not None and sr != ret_sr:
            raise RuntimeError(
                f"Expect sr={sr} of {fname}, get {ret_sr} instead")
        bytes_per_frame = channels * (bits // 8)
        total_frames = data_bytes // bytes_per_frame
        beg = int(beg or 0)
        stop = total_frames if end is None else min(int(end), total_frames)
        if beg:
            fd.seek(beg * bytes_per_frame, 1)
        raw = fd.read(max(stop - beg, 0) * bytes_per_frame)
    finally:
        if own:
            fd.close()
    samps = _decode(raw, bits, fmt_code, channels, normalize)
    if not normalize:
        samps = samps.astype(np.float32)
    if samps.ndim != 1:
        samps = np.transpose(samps)  # N x C -> C x N
    return samps


def write_wav(fname, samps, sr=16000, normalize=True):
    """Write single/multi-channel samples (C x N or N x C accepted).

    ``normalize=True`` writes float32 samples as PCM16 by scaling with
    2**15 (matching soundfile's float->PCM16 conversion used by the
    reference); ``normalize=False`` treats samples as already int16-ranged.
    """
    samps = np.asarray(samps)
    if samps.ndim != 1 and samps.shape[0] < samps.shape[1]:
        samps = np.squeeze(np.transpose(samps))
    if normalize:
        pcm = np.clip(np.round(samps * 32768.0), -32768, 32767).astype("<i2")
    else:
        pcm = np.clip(np.round(samps), -32768, 32767).astype("<i2")
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    data = np.ascontiguousarray(pcm).tobytes()
    fdir = os.path.dirname(str(fname))
    if fdir and not os.path.exists(fdir):
        os.makedirs(fdir, exist_ok=True)
    block = channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, _FMT_PCM, channels, sr,
                                 sr * block, block, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(fname, "wb") as fd:
        fd.write(hdr)
        fd.write(data)


def wav_info(fname):
    """(num_channels, sample_rate, num_frames) from the header only."""
    own = not hasattr(fname, "read")
    fd = open(fname, "rb") if own else fname
    try:
        channels, sr, bits, _, data_bytes = _parse_header(fd)
    finally:
        if own:
            fd.close()
    return channels, sr, data_bytes // (channels * (bits // 8))


def wav_duration(fname):
    """Duration in seconds from the header, without reading samples."""
    channels, sr, frames = wav_info(fname)
    return frames / sr
