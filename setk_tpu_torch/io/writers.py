"""Keyed writers: kaldi ark (+scp), wav dirs, npy dirs, mat dirs, exraw.

Parity: reference scripts/sptk/libs/data_handler.py:270-308,564-637.

The port's own copy of setk_tpu/io/writers.py (numpy only).
"""

import warnings
from pathlib import Path

import numpy as np

from setk_tpu_torch.io import kaldi, exraw
from setk_tpu_torch.io.fileio import _fopen
from setk_tpu_torch.io.wave import write_wav

__all__ = [
    "Writer", "ArchiveWriter", "WaveWriter", "NumpyWriter", "MatWriter",
    "ExrawWriter"
]


def _fclose(fname, fd):
    if fname and fname != "-" and fd is not None and fname[-1] != "|":
        fd.close()


class Writer:
    """Context-managed keyed writer, optionally emitting an index scp."""

    def __init__(self, obj_path_or_dir, scp_path=None, is_dir=False):
        self.scp_path = scp_path
        if obj_path_or_dir == "-" and scp_path:
            warnings.warn("Ignore script output descriptor because "
                          "archives are dumped to stdout")
            self.scp_path = None
        self.dump_out_dir = is_dir
        if is_dir:
            self.path_or_dir = Path(obj_path_or_dir).absolute()
            self.path_or_dir.mkdir(exist_ok=True, parents=True)
        else:
            self.path_or_dir = str(Path(obj_path_or_dir).absolute()) \
                if obj_path_or_dir != "-" else "-"

    def __enter__(self):
        if not self.dump_out_dir:
            self.ark_file = _fopen(str(self.path_or_dir), "wb")
        self.scp_file = _fopen(self.scp_path, "w")
        return self

    def __exit__(self, *args):
        if not self.dump_out_dir:
            _fclose(str(self.path_or_dir), self.ark_file)
        _fclose(self.scp_path, self.scp_file)

    def check_args(self, data):
        if not isinstance(data, np.ndarray):
            raise RuntimeError(
                f"Writer accepts np.ndarray objects, got {type(data)}")

    def write(self, key, data):
        raise NotImplementedError


class ArchiveWriter(Writer):
    """Kaldi ark writer (+ offset scp) for float/double/complex matrices."""

    def __init__(self, ark_path, scp_path=None, dtype=np.float32):
        if not ark_path:
            raise RuntimeError("Archive path is None/empty")
        super().__init__(ark_path, scp_path)
        self.dtype = dtype

    def write(self, key, obj):
        self.check_args(obj)
        kaldi.write_token(self.ark_file, key)
        offset = None
        if self.path_or_dir != "-":
            offset = self.ark_file.tell()
        kaldi.write_binary_symbol(self.ark_file)
        if self.dtype is not None and not np.iscomplexobj(obj):
            obj = obj.astype(self.dtype)
        kaldi.write_value(self.ark_file, obj)
        if self.scp_file:
            self.scp_file.write(f"{key}\t{self.path_or_dir}:{offset}\n")


class WaveWriter(Writer):
    def __init__(self, dump_dir, scp_path=None, sr=16000, normalize=True):
        super().__init__(dump_dir, scp_path, is_dir=True)
        self.sr = sr
        self.normalize = normalize

    def write(self, key, obj):
        self.check_args(obj)
        obj_path = self.path_or_dir / f"{key}.wav"
        write_wav(obj_path, obj, sr=self.sr, normalize=self.normalize)
        if self.scp_file:
            self.scp_file.write(f"{key}\t{obj_path}\n")


class NumpyWriter(Writer):
    def __init__(self, dump_dir, scp_path=None):
        super().__init__(dump_dir, scp_path, is_dir=True)

    def write(self, key, obj):
        self.check_args(obj)
        obj_path = self.path_or_dir / f"{key}.npy"
        np.save(obj_path, obj)
        if self.scp_file:
            self.scp_file.write(f"{key}\t{obj_path}\n")


class MatWriter(Writer):
    def __init__(self, dump_dir, scp_path=None):
        super().__init__(dump_dir, scp_path, is_dir=True)

    def write(self, key, obj):
        import scipy.io as sio
        self.check_args(obj)
        obj_path = self.path_or_dir / f"{key}.mat"
        sio.savemat(obj_path, {"data": obj})
        if self.scp_file:
            self.scp_file.write(f"{key}\t{obj_path}\n")


class ExrawWriter(Writer):
    """exraw archive writer (+ offset scp)."""

    def __init__(self, obj_path, scp_path=None):
        if not obj_path:
            raise RuntimeError("ExrawWriter got empty object path")
        super().__init__(obj_path, scp_path)

    def write(self, key, obj):
        self.check_args(obj)
        self.ark_file.write((key + " ").encode())
        offset = self.ark_file.tell()
        exraw.serialize(self.ark_file, np.ascontiguousarray(obj))
        if self.scp_file:
            self.scp_file.write(f"{key}\t{self.path_or_dir}:{offset}\n")
