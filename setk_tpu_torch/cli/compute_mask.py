#!/usr/bin/env python
"""Compute oracle T-F masks (irm/ibm/iam/psm/psa/crm) as training targets.

The port's counterpart of ``setk_tpu/cli/compute_mask.py`` (same flags,
the same clip logging), with ``--device`` (``cuda`` by default, ``cpu``
for the CPU): the masks are elementwise in ``enhance.masks.compute_mask``
on the device, the STFTs the readers' on the host.

    python -m setk_tpu_torch.cli compute_mask clean.scp noisy.scp \\
        target.ark --scp target.scp --mask irm
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import StftParser, stft_config_from_args
from setk_tpu_torch.enhance.masks import MASK_TYPES, compute_mask
from setk_tpu_torch.io import ArchiveWriter, ExrawWriter, SpectrogramReader
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    clean_reader = SpectrogramReader(args.clean_scp, cfg=cfg)
    noisy_reader = SpectrogramReader(args.noisy_scp, cfg=cfg)
    writer_cls = {"kaldi": ArchiveWriter, "exraw": ExrawWriter}[args.format]
    num_utts = 0
    with writer_cls(args.mask_ark, args.scp) as writer:
        for key, clean in clean_reader:
            if key not in noisy_reader:
                logger.warning(f"Missing noisy utterance for {key}")
                continue
            noisy = noisy_reader[key]
            spec = [torch.from_numpy(x[0] if x.ndim == 3 else x).to(device)
                    for x in (clean, noisy)]
            mask = compute_mask(*spec, args.mask).cpu().numpy()
            if args.cutoff > 0:
                clipped = int(np.sum(mask > args.cutoff))
                if clipped:
                    logger.info(f"Clip {clipped}"
                                f"({clipped / mask.size:.2f}) items over "
                                f"{args.cutoff:.2f} for utterance {key}")
                mask = np.minimum(mask, args.cutoff)
            below = int(np.sum(mask < 0))
            if below:
                logger.info(f"Clip {below}({below / mask.size:.2f}) items "
                            f"below zero for utterance {key}")
                mask = np.maximum(mask, 0)
            writer.write(key, mask.astype(np.float32))
            num_utts += 1
    logger.info(f"Processed {num_utts} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute T-F masks as training targets "
        "(2-component case: speech & noise)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("clean_scp", help="Clean speech script")
    parser.add_argument("noisy_scp", help="Noisy speech script")
    parser.add_argument("mask_ark", help="Output mask archive")
    parser.add_argument("--format", default="kaldi",
                        choices=["kaldi", "exraw"])
    parser.add_argument("--scp", default="",
                        help="Also emit an index scp")
    parser.add_argument("--mask", default="irm", choices=list(MASK_TYPES))
    parser.add_argument("--cutoff", type=float, default=-1,
                        help="Cutoff for unbounded masks (<=0: none)")
    parser.add_argument("--device", default="cuda",
                        help="Where the masks are computed (cuda or cpu)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
