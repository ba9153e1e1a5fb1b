#!/usr/bin/env python
"""Directional features from a geometry's steer vectors (+ utt2idx DoAs).

The port's counterpart of ``setk_tpu/cli/compute_df_on_geometry.py``,
with the same flags and ``--device`` (``cuda`` by default, ``cpu`` for
the plain path): the steering grid and each utterance's STFT lie on that
device.

    python -m setk_tpu_torch.cli compute_df_on_geometry wav.scp sv.npy \\
        df.ark --utt2idx utt2idx --df-pair "0,1;0,2"
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args)
from setk_tpu_torch.io import ArchiveWriter, ScpReader, SpectrogramReader
from setk_tpu_torch.spatial.features import directional_feats
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    utt2idx = ScpReader(args.utt2idx, value_processor=int) \
        if args.utt2idx else None
    df_pair = [tuple(map(int, p.split(","))) for p in args.df_pair.split(";")]
    logger.info(f"Compute directional features with {df_pair}")
    # A x M x F
    steer_vector = torch.from_numpy(np.load(args.steer_vector)).to(device)
    num_done = 0
    with ArchiveWriter(args.dup_ark, args.scp) as writer:
        for key, stft in reader:
            if utt2idx is not None and key not in utt2idx:
                logger.warning(f"Missing utt2idx for utterance {key}")
                continue
            stft = torch.from_numpy(stft).to(device)
            if utt2idx is None:
                idx = [int(v) for v in args.doa_idx.split(",")]
                dfs = [directional_feats(stft, steer_vector[i],
                                         df_pair=df_pair) for i in idx]
                # (T, F) each -> (T, len(idx) F)
                df = dfs[0] if len(dfs) == 1 else torch.cat(dfs, dim=-1)
            else:
                df = directional_feats(stft, steer_vector[utt2idx[key]],
                                       df_pair=df_pair)
            writer.write(key, df.cpu().numpy().astype(np.float32))
            num_done += 1
            if num_done % 1000 == 0:
                logger.info(f"Processed {num_done} utterances...")
    logger.info(f"Processed {num_done} utterances over {len(reader)} "
                f"({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Directional features from geometry steer vectors",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("steer_vector", help=".npy steering grid A x M x F")
    parser.add_argument("dup_ark", help="Output archive")
    parser.add_argument("--scp", default="")
    parser.add_argument("--utt2idx", default="",
                        help="Per-utterance DoA index script")
    parser.add_argument("--doa-idx", default="0",
                        help="Fixed DoA indices (comma-separated)")
    parser.add_argument("--df-pair", default="0,1", help="Mic pairs")
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
