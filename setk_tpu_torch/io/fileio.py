"""Extended file opening: ``-`` (stdin/stdout) and trailing-``|`` pipes.

Behavioral parity with the reference's stream plumbing
(reference scripts/sptk/libs/data_handler.py:31-137): an rspecifier
ending in ``|`` is a shell command whose stdout is the stream; ``-`` maps to
stdin/stdout.

The port's own copy of setk_tpu/io/fileio.py (numpy only).
"""

import codecs
import os
import subprocess
import sys
import threading
import warnings
import _thread
from contextlib import contextmanager

__all__ = ["ext_open", "run_command"]


def run_command(command, wait=True):
    """Run a shell command (usually a pipe chain); return (stdout, stderr)."""
    p = subprocess.Popen(command,
                         shell=True,
                         stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
    if not wait:
        return p
    stdout, stderr = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(
            f"Error running command \"{command}\":\n{bytes.decode(stderr)}")
    return stdout, stderr


def _pipe_fopen(command, mode):
    if mode not in ("rb", "r"):
        raise RuntimeError("Only input pipes are supported")
    p = subprocess.Popen(command, shell=True, stdout=subprocess.PIPE)

    def waiter():
        p.wait()
        if p.returncode != 0:
            warnings.warn(
                f"Command \"{command}\" exited with status {p.returncode}")
            _thread.interrupt_main()

    thread = threading.Thread(target=waiter, daemon=True)
    thread.start()
    return p.stdout


def _fopen(fname, mode):
    if mode not in ("w", "r", "wb", "rb"):
        raise ValueError(f"Unknown open mode: {mode}")
    if isinstance(fname, os.PathLike):
        fname = os.fspath(fname)
    if not fname:
        return None
    fname = fname.strip()
    if fname == "-":
        if mode in ("w", "wb"):
            return sys.stdout.buffer if mode == "wb" else sys.stdout
        return sys.stdin.buffer if mode == "rb" else sys.stdin
    if fname[-1] == "|":
        pin = _pipe_fopen(fname[:-1], mode)
        return pin if mode == "rb" else codecs.getreader("utf-8")(pin)
    if mode in ("r", "rb") and not os.path.exists(fname):
        raise FileNotFoundError(f"Could not find common file: \"{fname}\"")
    if mode in ("r", "w"):
        return codecs.open(fname, mode, encoding="utf-8")
    return open(fname, mode)


@contextmanager
def ext_open(fname, mode):
    if isinstance(fname, os.PathLike):
        fname = os.fspath(fname)
    fd = _fopen(fname, mode)
    try:
        yield fd
    finally:
        if fname and fname != "-" and fd is not None and fname[-1] != "|":
            fd.close()
