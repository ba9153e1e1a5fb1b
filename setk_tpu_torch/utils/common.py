"""Shared numeric constants and small host-side helpers.

Counterpart of ``setk_tpu/utils/common.py`` (EPSILON, MAX_INT16,
nextpow2, filekey, check_doa).  The TPU's ``GRAM_PRECISION`` knob has no
port: the port's plain paths run in full float32 on the card
(``utils.device.full_f32_matmuls`` turns TF32 off where they run).
"""

import math
import os

import numpy as np

__all__ = ["EPSILON", "MAX_INT16", "nextpow2", "filekey", "check_doa"]

# float32 machine epsilon — the toolkit-wide flooring constant
EPSILON = float(np.finfo(np.float32).eps)
MAX_INT16 = np.iinfo(np.int16).max


def nextpow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 2**math.ceil(math.log2(n))


def filekey(path: str) -> str:
    """Unique utterance key from a file name (basename minus last extension)."""
    fname = os.path.basename(path)
    if not fname:
        raise ValueError(f"{path}: is directory path?")
    token = fname.split(".")
    if len(token) == 1:
        return token[0]
    return ".".join(token[:-1])


def check_doa(geometry: str, doa, online: bool = False) -> bool:
    """Validate DoA range: [0, 180] for linear arrays, [0, 360) for circular
    (every DoA of the track when ``online``)."""
    doas = doa if online else [doa]
    for d in doas:
        if d < 0:
            return False
        if geometry == "linear" and d > 180:
            return False
        if geometry == "circular" and d >= 360:
            return False
    return True
