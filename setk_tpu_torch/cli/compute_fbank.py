#!/usr/bin/env python
"""Mel filterbank features -> archives.

The port's counterpart of ``setk_tpu/cli/compute_fbank.py`` (HTK mel
scale, Slaney norm, kaldi/exraw output), with the same flags and
``--device`` (``cuda`` by default, ``cpu`` for the plain path): each
utterance's samples go to that device, where the magnitude STFT and the
filterbank product run.

    python -m setk_tpu_torch.cli compute_fbank wav.scp fbank.ark --scp fbank.scp
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.mel import mel_fbank, mel_filterbank
from setk_tpu_torch.dsp.stft import forward_stft
from setk_tpu_torch.io import ArchiveWriter, ExrawWriter, WaveReader
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    full_f32_matmuls(device)
    cfg = stft_config_from_args(args)
    if args.max_freq > args.sr // 2:
        raise RuntimeError("Max mel frequency exceeds Nyquist")
    reader = WaveReader(args.wav_scp)
    weights = mel_filterbank(args.sr, cfg.n_fft, num_mels=args.num_bins,
                             fmin=args.min_freq, fmax=args.max_freq)
    writer_cls = {"kaldi": ArchiveWriter, "exraw": ExrawWriter}[args.format]
    with writer_cls(args.dup_ark, args.scp) as writer:
        for key, samps in reader:
            samps = torch.from_numpy(np.ascontiguousarray(samps)).to(device)
            mag = forward_stft(samps, cfg, apply_abs=True)
            mag = mag[0] if mag.ndim == 3 else mag  # T x F
            fbank = mel_fbank(mag, weights, apply_log=args.log)
            writer.write(key, fbank.cpu().numpy().astype(np.float32))
    logger.info(f"Processed {len(reader)} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Extract mel-fbank features into archives",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Input wave scripts")
    parser.add_argument("dup_ark", help="Output archive")
    parser.add_argument("--scp", default="")
    parser.add_argument("--format", default="kaldi",
                        choices=["kaldi", "exraw"])
    parser.add_argument("--num-bins", type=int, default=80,
                        help="Number of mel bins")
    parser.add_argument("--min-freq", type=float, default=0)
    parser.add_argument("--max-freq", type=float, default=8000)
    parser.add_argument("--log", type=strtobool, default=True)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
