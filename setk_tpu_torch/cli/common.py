"""Shared CLI plumbing: the STFT argparse fragment and small helpers.

The port's copy of ``setk_tpu/cli/common.py`` (StftParser, strtobool,
str2tuple, stft_config_from_args, pad_to_bucket), and the ``--device``
flag every command of the port takes.
"""

import argparse

import numpy as np

__all__ = ["StftParser", "strtobool", "str2tuple", "stft_config_from_args",
           "pad_to_bucket", "refuse_data_parallel", "add_device_flag"]


def strtobool(value):
    value = str(value).lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return True
    if value in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"Invalid bool value: {value}")


def str2tuple(string, sep=","):
    """Map "1.0,2.0" => (1.0, 2.0)."""
    return tuple(map(float, string.split(sep)))


def add_device_flag(parser):
    """``--device``: where a command computes (``cuda`` by default)."""
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (the card) or cpu (the "
                        "plain path)")
    return parser


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


def refuse_data_parallel(data_parallel: bool, device) -> None:
    """--data-parallel over more than one card is ROADMAP queue 1 item 12;
    on one card (or the CPU) it changes nothing."""
    import torch
    if data_parallel and device.type == "cuda" and \
            torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--data-parallel over more than one card arrives with ROADMAP "
            "queue 1 item 12")
