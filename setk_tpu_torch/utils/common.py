"""Shared numeric constants and small host-side helpers.

Counterpart of ``setk_tpu/utils/common.py`` (EPSILON, MAX_INT16,
nextpow2).  The TPU's ``GRAM_PRECISION`` knob has no port: the port's
plain paths run in full float32 on the card (``utils.device.
full_f32_matmuls`` turns TF32 off where they run).
"""

import math

import numpy as np

__all__ = ["EPSILON", "MAX_INT16", "nextpow2"]

# float32 machine epsilon — the toolkit-wide flooring constant
EPSILON = float(np.finfo(np.float32).eps)
MAX_INT16 = np.iinfo(np.int16).max


def nextpow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 2**math.ceil(math.log2(n))
