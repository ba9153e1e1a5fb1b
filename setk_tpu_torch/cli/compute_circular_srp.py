#!/usr/bin/env python
"""Diagonal-pair GCC-PHAT (SRP) features for circular arrays.

The port's counterpart of ``setk_tpu/cli/compute_circular_srp.py``, with
the same flags and ``--device`` (``cuda`` by default, ``cpu`` for the
plain path).  Pair (i, j) is taken at angle min(i, j) 2 pi / n, the
reference's convention; an utterance whose features hold a NaN stops the
run.

    python -m setk_tpu_torch.cli compute_circular_srp wav.scp srp.ark \\
        --scp srp.scp --diag-pair "0,3;1,4;2,5"
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args)
from setk_tpu_torch.io import ArchiveWriter, SpectrogramReader
from setk_tpu_torch.spatial.features import (gcc_phat_diag,
                                             smooth_angular_spectrogram)
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    full_f32_matmuls(device)
    srp_pair = [tuple(map(int, p.split(",")))
                for p in args.diag_pair.split(";")]
    logger.info(f"Compute gcc with {srp_pair}")
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg)  # N x T x F
    num_done = 0
    with ArchiveWriter(args.srp_ark, args.scp) as writer:
        for key, spectra in reader:
            spectra = torch.from_numpy(spectra).to(device)
            srp = torch.stack([
                gcc_phat_diag(spectra[i], spectra[j],
                              min(i, j) * np.pi * 2 / args.n, args.d,
                              num_bins=cfg.num_bins, sr=args.sr,
                              num_doas=args.num_doas)
                for (i, j) in srp_pair
            ]).mean(0)
            if args.smooth_context > 0:
                srp = smooth_angular_spectrogram(srp, args.smooth_context)
            srp = srp.cpu().numpy()
            if np.sum(np.isnan(srp)):
                raise RuntimeError(f"Matrix {key} has NaN items")
            writer.write(key, srp.astype(np.float32))
            num_done += 1
            if num_done % 1000 == 0:
                logger.info(f"Processed {num_done} utterances...")
    logger.info(f"Processed {len(reader)} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute circular-array SRP features (diagonal pairs)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("srp_ark", help="Output archive")
    parser.add_argument("--scp", default="")
    parser.add_argument("--diag-pair", default="0,3;1,4;2,5",
                        help="Diagonal mic pairs")
    parser.add_argument("--n", type=int, default=6,
                        help="Mics around the circle")
    parser.add_argument("--d", type=float, default=0.1,
                        help="Diameter of the circular array")
    parser.add_argument("--num-doas", type=int, default=121)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--smooth-context", dest="smooth_context",
                        type=int, default=0,
                        help="Temporal context for angular-spectrogram "
                        "averaging (0 disables)")
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
