#!/usr/bin/env python
"""Directional features from mask-estimated steer vectors.

The port's counterpart of ``setk_tpu/cli/compute_df_on_mask.py``, with
the same flags and ``--device`` (``cuda`` by default, ``cpu`` for the
plain path): mask (capped at 1) -> masked covariance -> principal
eigenvector -> directional features.  On the card the covariance is the
masked covariance kernel (kernel 13) and the eigenvector the EVD kernel,
one launch each an utterance.  An eigenvector's phase is arbitrary, and
the features use only phase differences between mics, so they do not
depend on it.

    python -m setk_tpu_torch.cli compute_df_on_mask wav.scp mask.scp \\
        df.ark --fmt numpy --df-pair "0,1;0,2"
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args)
from setk_tpu_torch.enhance.beamformer import compute_covar
from setk_tpu_torch.io import ArchiveWriter, MaskReader, SpectrogramReader
from setk_tpu_torch.ops.linalg import solve_pevd
from setk_tpu_torch.spatial.features import directional_feats
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    full_f32_matmuls(device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    mask_reader = MaskReader(args.fmt, args.mask_scp)
    df_pair = [tuple(map(int, p.split(","))) for p in args.df_pair.split(";")]
    logger.info(f"Compute directional features with {df_pair}")
    num_done = 0
    with ArchiveWriter(args.dup_ark, args.scp) as writer:
        for key, obs in reader:
            if key not in mask_reader:
                logger.warning(f"Missing TF-mask for utterance {key}")
                continue
            mask = np.asarray(mask_reader[key])
            _, f_bins, _ = obs.shape
            if mask.shape[0] == f_bins:
                mask = mask.T
            # T x F -> F x T, capped at 1
            mask = torch.clamp(torch.from_numpy(np.ascontiguousarray(
                mask.T)).to(device, torch.float32), max=1)
            obs = torch.from_numpy(obs).to(device)         # N x F x T
            covar = compute_covar(obs.transpose(0, 1), mask)
            sv = solve_pevd(covar)                         # F x N
            df = directional_feats(obs, sv.T, df_pair=df_pair)
            writer.write(key, df.cpu().numpy().astype(np.float32))
            num_done += 1
            if num_done % 1000 == 0:
                logger.info(f"Processed {num_done} utterances...")
    logger.info(f"Processed {num_done} utterances over {len(reader)} "
                f"({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Directional features from mask-estimated steer vectors",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("mask_scp", help="T-F mask scripts")
    parser.add_argument("dup_ark", help="Output archive")
    parser.add_argument("--scp", default="")
    parser.add_argument("--fmt", default="kaldi",
                        choices=["kaldi", "numpy", "exraw"])
    parser.add_argument("--df-pair", default="0,1", help="Mic pairs")
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
