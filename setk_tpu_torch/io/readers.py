"""Keyed utterance readers: scp/ark/wav/npy/mat/pickle/raw/dir.

Same reader family and semantics as the reference
(reference scripts/sptk/libs/data_handler.py:23-28,139-561):
``-``/pipe rspecifiers, glob multi-channel wav patterns, wav-ark offset
reads, kaldi-script random access.  Implementation is fresh (pathlib,
context-managed pipes, vectorized codecs).

The port's own copy of setk_tpu/io/readers.py (numpy only).
"""

import glob
import pickle
import random
from io import BytesIO
from pathlib import Path

import numpy as np

from setk_tpu_torch.io import kaldi, exraw
from setk_tpu_torch.io.fileio import ext_open, run_command
from setk_tpu_torch.io.wave import read_wav
from setk_tpu_torch.utils.common import filekey

__all__ = [
    "parse_scps", "Reader", "ScpReader", "DirReader", "WaveReader",
    "SegmentWaveReader", "SpectrogramReader", "NumpyReader", "PickleReader",
    "MatReader", "BinaryReader", "ScriptReader", "ArchiveReader",
    "ExrawReader", "ExrawScriptReader", "MaskReader", "NumpyDirReader"
]


def parse_scps(scp_path,
               value_processor=lambda x: x,
               num_tokens=2,
               restrict=True):
    """Parse a Kaldi-style .scp file (stdin/pipe rspecifiers supported)."""
    scp_dict = {}
    with ext_open(scp_path, "r") as f:
        for lineno, raw_line in enumerate(f, 1):
            toks = raw_line.strip().split()
            if not toks:
                continue
            if toks[-1] == "|":
                key, value = toks[0], " ".join(toks[1:])
            else:
                if (num_tokens >= 2 and len(toks) != num_tokens) or \
                        (restrict and len(toks) < 2):
                    raise RuntimeError(f"For {scp_path}, format error in "
                                       f"line[{lineno}]: {raw_line}")
                if num_tokens == 2:
                    key, value = toks
                else:
                    key, value = toks[0], toks[1:]
            if key in scp_dict:
                raise ValueError(f"Duplicated key '{key}' exists in {scp_path}")
            scp_dict[key] = value_processor(value)
    return scp_dict


class Reader:
    """Base keyed reader: iteration, random access, sampling."""

    def __init__(self, index_dict):
        self.index_dict = index_dict
        self.index_keys = list(index_dict.keys())

    def _load(self, key):
        return self.index_dict[key]

    def sample(self, num_items):
        keys = random.sample(self.index_keys, num_items)
        samp = [(key, self._load(key)) for key in keys]
        return samp[0] if num_items == 1 else samp

    def __len__(self):
        return len(self.index_dict)

    def __contains__(self, key):
        return key in self.index_dict

    def __iter__(self):
        for key in self.index_keys:
            yield key, self._load(key)

    def __getitem__(self, index):
        if isinstance(index, int):
            if not 0 <= index < len(self.index_keys):
                raise KeyError(f"Integer index out of range: "
                               f"{index} vs {len(self.index_keys)}")
            index = self.index_keys[index]
        elif not isinstance(index, str):
            raise IndexError(f"Unsupported index type: {type(index)}")
        if index not in self.index_dict:
            raise KeyError(f"Missing utterance {index}!")
        return self._load(index)

    def get(self, index, default=None):
        return self[index] if index in self else default

    def keys(self):
        return self.index_keys


class ScpReader(Reader):
    def __init__(self,
                 scp_rspecifier,
                 value_processor=lambda x: x,
                 num_tokens=2,
                 restrict=True):
        super().__init__(
            parse_scps(scp_rspecifier,
                       value_processor=value_processor,
                       num_tokens=num_tokens,
                       restrict=restrict))


class DirReader(Reader):
    """Index every ``*.<suffix>`` file under a directory by its filekey."""

    def __init__(self, obj_dir, suffix):
        obj_dir = Path(obj_dir)
        if not obj_dir.is_dir():
            raise RuntimeError("DirReader expects a directory as input")
        flist = glob.glob((obj_dir / f"*.{suffix}").as_posix())
        super().__init__({filekey(f): f for f in flist})


class WaveReader(ScpReader):
    """Single/multi-channel wave reader.

    The scp value may be a plain path, a glob pattern (multi-channel,
    sorted channel order), a ``cmd |`` pipe, or a ``path:offset`` wav-ark
    address.
    """

    def __init__(self, wav_scp, sr=16000, normalize=True, native="auto"):
        super().__init__(wav_scp)
        self.sr = sr
        self.normalize = normalize
        self._ark_fds = {}
        # plain-path decodes go through the native loader when available
        # (bit-exact against the Python decoder, io/wave.py)
        if native == "auto":
            from setk_tpu_torch.utils.native import native_available
            self.native = native_available()
        else:
            self.native = bool(native)

    def _read_addr(self, addr, beg=None, end=None):
        if isinstance(addr, str) and ":" in addr:
            fname, _, offset = addr.rpartition(":")
            if fname not in self._ark_fds:
                self._ark_fds[fname] = open(fname, "rb")
            fd = self._ark_fds[fname]
            fd.seek(int(offset))
            return read_wav(fd, beg=beg, end=end,
                            normalize=self.normalize, sr=self.sr)
        if self.native:
            from setk_tpu_torch.io.native_wav import read_wav_native
            return read_wav_native(addr, beg=beg or 0, end=end,
                                   normalize=self.normalize, sr=self.sr)
        return read_wav(addr, beg=beg, end=end,
                        normalize=self.normalize, sr=self.sr)

    def read(self, key, beg=None, end=None):
        fname = self.index_dict[key].rstrip()
        if fname[-1] == "|":
            stdout, _ = run_command(fname[:-1], wait=True)
            return self._read_addr(BytesIO(stdout))
        wav_list = glob.glob(fname) if any(c in fname
                                           for c in "*?[") else [fname]
        if len(wav_list) == 0:
            raise RuntimeError(f"Could not find file matching '{fname}'")
        if len(wav_list) == 1:
            return self._read_addr(wav_list[0], beg=beg, end=end)
        # channel order is sorted — sensitive for beamforming
        return np.vstack([
            self._read_addr(addr, beg=beg, end=end)
            for addr in sorted(wav_list)
        ])

    def _load(self, key):
        return self.read(key)

    def maxabs(self, key):
        return np.max(np.abs(self.read(key)))

    def duration(self, key):
        return self.read(key).shape[-1] / self.sr

    def nsamps(self, key):
        return self.read(key).shape[-1]

    def power(self, key):
        samps = self.read(key)
        s = samps if samps.ndim == 1 else samps[0]
        return np.linalg.norm(s, 2)**2 / s.size


class SegmentWaveReader(ScpReader):
    """Wave reader driven by a Kaldi ``segments`` file (key wav beg end)."""

    def __init__(self, wav_scp, segments, sr=16000, normalize=True):
        def processor(x):
            wav, beg, end = x
            return {"wav": wav, "beg": float(beg), "end": float(end)}

        super().__init__(segments, num_tokens=4, value_processor=processor)
        self.wav_reader = WaveReader(wav_scp, sr=sr, normalize=normalize)

    def _load(self, key):
        info = self.index_dict[key]
        return self.wav_reader.read(info["wav"],
                                    beg=int(info["beg"]),
                                    end=int(info["end"]))


class SpectrogramReader(WaveReader):
    """Wave reader that yields (multi-channel) STFTs.

    Accepts either an StftConfig (``cfg=``) or the reference-style kwargs
    (frame_len/frame_hop/center/round_power_of_two/window plus
    apply_abs/apply_log/apply_pow/transpose).  Returns numpy arrays,
    F x T by default (transpose=True gives T x F) with a leading channel
    axis for multi-channel input — matching the reference reader
    (reference scripts/sptk/libs/data_handler.py:483-503).
    """

    def __init__(self, wav_scp, normalize=True, sr=16000, cfg=None, **kwargs):
        super().__init__(wav_scp, sr=sr, normalize=normalize)
        from setk_tpu_torch.dsp.stft import StftConfig
        self.post = {
            k: kwargs.pop(k, False)
            for k in ("apply_abs", "apply_log", "apply_pow")
        }
        self.transpose = kwargs.pop("transpose", True)
        self.cfg = cfg if cfg is not None else StftConfig(**kwargs)

    def _load(self, key):
        import torch
        from setk_tpu_torch.dsp.stft import forward_stft
        samps = self.read(key)
        # IO-level STFT runs on the host CPU (the port's plain STFT)
        spec = forward_stft(torch.from_numpy(np.ascontiguousarray(samps)),
                            self.cfg, **self.post).numpy()
        if not self.transpose:
            spec = np.swapaxes(spec, -1, -2)
        return spec


class NumpyReader(ScpReader):
    def _load(self, key):
        return np.load(self.index_dict[key])


class PickleReader(ScpReader):
    def _load(self, key):
        with open(self.index_dict[key], "rb") as f:
            return pickle.load(f)


class MatReader(ScpReader):
    """MATLAB .mat reader: extracts a fixed variable from each file."""

    def __init__(self, mat_scp, key):
        super().__init__(mat_scp)
        self.key = key

    def _load(self, key):
        import scipy.io as sio
        mat_dict = sio.loadmat(self.index_dict[key])
        if self.key not in mat_dict:
            raise KeyError(f"Could not find '{self.key}' in {key}")
        return mat_dict[self.key]


class BinaryReader(ScpReader):
    """Raw little-endian binary blob reader."""

    _DTYPES = {
        "float32": np.float32,
        "float64": np.float64,
        "int32": np.int32,
        "int64": np.int64
    }

    def __init__(self, bin_scp, length=None, data_type="float32"):
        super().__init__(bin_scp)
        if data_type not in self._DTYPES:
            raise RuntimeError(f"Unsupported data type: {data_type}")
        self.fmt = self._DTYPES[data_type]
        self.length = length

    def _load(self, key):
        obj = np.fromfile(self.index_dict[key], dtype=self.fmt)
        if self.length is not None and obj.size != self.length:
            raise RuntimeError(
                f"Expect length {self.length}, but got {obj.size}")
        return obj


class ScriptReader(ScpReader):
    """Random-access reader over kaldi ark offsets (``path:offset`` values)."""

    def __init__(self, ark_scp):
        def addr_processor(addr):
            path, _, offset = addr.rpartition(":")
            if not path:
                raise ValueError("Unsupported script address format")
            return (path, int(offset))

        super().__init__(ark_scp, value_processor=addr_processor)
        self._fds = {}

    def _load(self, key):
        path, addr = self.index_dict[key]
        if path not in self._fds:
            self._fds[path] = open(path, "rb")
        fd = self._fds[path]
        fd.seek(addr)
        return kaldi.read_value(fd, direct_access=True)


class ArchiveReader:
    """Sequential reader over a binary kaldi ark stream (file/pipe/stdin)."""

    def __init__(self, ark_or_pipe):
        self.ark_or_pipe = ark_or_pipe

    def __iter__(self):
        with ext_open(self.ark_or_pipe, "rb") as fd:
            yield from kaldi.read_ark(fd)


class ExrawReader:
    """Sequential reader over an exraw archive."""

    def __init__(self, obj_path):
        self.obj_path = obj_path

    def __iter__(self):
        with open(self.obj_path, "rb") as fd:
            yield from exraw.read_exraw(fd)


class ExrawScriptReader(Reader):
    """Random-access exraw reader via an offset scp."""

    def __init__(self, scp):
        super().__init__(exraw.parse_exraw_scp(scp))
        self._fds = {}

    def _load(self, key):
        obj, addr = self.index_dict[key]
        if obj not in self._fds:
            self._fds[obj] = open(obj, "rb")
        return exraw.deserialize(self._fds[obj], addr)


class NumpyDirReader(DirReader):
    """Directory of ``<key>.npy`` files (the reference's DirReader mask
    convention, data_handler.py:256-267)."""

    def __init__(self, obj_dir):
        super().__init__(obj_dir, "npy")

    def _load(self, key):
        return np.load(self.index_dict[key])


def MaskReader(fmt, path, **kwargs):
    """Factory for T-F mask readers by format name, mirroring the CLI
    ``--mask-format`` switch (numpy/kaldi/exraw).  The numpy flavor
    accepts either an scp index or a directory of .npy files (reference
    parity: masks are passed as "scp/dir")."""
    if fmt == "numpy":
        if Path(path).is_dir():
            return NumpyDirReader(path)
        return NumpyReader(path)
    if fmt == "kaldi":
        return ScriptReader(path)
    if fmt == "exraw":
        return ExrawScriptReader(path)
    raise ValueError(f"Unknown mask format: {fmt}")
