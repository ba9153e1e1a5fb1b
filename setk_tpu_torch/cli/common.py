"""Shared CLI plumbing: the STFT argparse fragment and small helpers.

The port's copy of ``setk_tpu/cli/common.py`` (StftParser, strtobool,
stft_config_from_args, pad_to_bucket).
"""

import argparse

import numpy as np

__all__ = ["StftParser", "strtobool", "stft_config_from_args",
           "pad_to_bucket"]


def strtobool(value):
    value = str(value).lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return True
    if value in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"Invalid bool value: {value}")


class StftParser:
    """Shared STFT argparse fragment (same flags as setk_tpu's)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--frame-len", type=int, default=512,
                        help="Frame length in number of samples")
    parser.add_argument("--frame-hop", type=int, default=256,
                        help="Frame shift in number of samples")
    parser.add_argument("--center", type=strtobool, default=True,
                        help="Center padding for the STFT")
    parser.add_argument("--round-power-of-two", type=strtobool, default=True,
                        help="If true, pad FFT size to a power of two")
    parser.add_argument("--window", type=str, default="hann",
                        help="Type of window function "
                        "(hann/sqrthann/hamming/blackman/rect)")


def stft_config_from_args(args):
    from setk_tpu_torch.dsp.stft import StftConfig
    return StftConfig(frame_len=args.frame_len,
                      frame_hop=args.frame_hop,
                      window=args.window,
                      center=bool(args.center),
                      round_power_of_two=bool(args.round_power_of_two))


def pad_to_bucket(arr: np.ndarray, axis: int, bucket: int = 64):
    """Zero-pad one axis to a multiple of ``bucket``; returns
    (padded, original length)."""
    n = arr.shape[axis]
    target = -(-n // bucket) * bucket
    if target == n:
        return arr, n
    width = [(0, 0)] * arr.ndim
    width[axis] = (0, target - n)
    return np.pad(arr, width), n
