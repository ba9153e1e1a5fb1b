#!/usr/bin/env python
"""Linear/log (magnitude/power) spectrogram features -> archives.

The port's counterpart of ``setk_tpu/cli/compute_spectrogram.py``, with
the same flags and ``--device`` (``cuda`` by default, ``cpu`` for the
plain path): each utterance's samples go to that device, where the STFT
and its magnitude, power and log run (the JAX command takes them from
its reader's host STFT; the port's reader computes the same on the
CPU).

    python -m setk_tpu_torch.cli compute_spectrogram wav.scp spec.ark --scp spec.scp
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import forward_stft
from setk_tpu_torch.io import ArchiveWriter, ExrawWriter, WaveReader
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = WaveReader(args.wav_scp)
    writer_cls = {"kaldi": ArchiveWriter, "exraw": ExrawWriter}[args.format]
    with writer_cls(args.dup_ark, args.scp) as writer:
        for key, samps in reader:
            samps = torch.from_numpy(np.ascontiguousarray(samps)).to(device)
            feats = forward_stft(samps, cfg, apply_abs=True,
                                 apply_log=args.apply_log,
                                 apply_pow=args.apply_pow)
            feats = feats[0] if feats.ndim == 3 else feats
            writer.write(key, feats.cpu().numpy().astype(np.float32))
    logger.info(f"Processed {len(reader)} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Extract spectrogram features into archives",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Input wave scripts")
    parser.add_argument("dup_ark", help="Output archive")
    parser.add_argument("--scp", default="")
    parser.add_argument("--format", default="kaldi",
                        choices=["kaldi", "exraw"])
    parser.add_argument("--apply-log", type=strtobool, default=True)
    parser.add_argument("--apply-pow", type=strtobool, default=False)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
