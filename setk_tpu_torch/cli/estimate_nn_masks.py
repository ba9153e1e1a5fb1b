#!/usr/bin/env python
"""Estimate T-F masks with a trained neural estimator.

The port's counterpart of ``setk_tpu/cli/estimate_nn_masks.py``: a
checkpoint of either package -> per-utterance masks (.npy, T x F), with
``--device`` (``cuda`` by default, ``cpu`` for the CPU).  Each utterance's
frames are zero-padded to a multiple of 64 as the JAX CLI pads them: a
BLSTM's backward direction reads the padded frames first, so the masks
depend on the padding.

    python -m setk_tpu_torch.cli estimate_nn_masks wav.scp final.msgpack \\
        masks/ --scp masks.scp
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import pad_to_bucket
from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.io import NumpyWriter, SpectrogramReader
from setk_tpu_torch.models.trainer import load_checkpoint
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    model, meta = load_checkpoint(args.checkpoint, device=device)
    full_f32_matmuls(device)
    cfg = StftConfig(frame_len=meta["frame_len"],
                     frame_hop=meta["frame_hop"],
                     window=meta["window"],
                     center=meta["center"],
                     round_power_of_two=meta["round_power_of_two"])
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, apply_abs=True,
                               apply_log=True)
    num_done = 0
    with NumpyWriter(args.dst_dir, args.scp) as writer, torch.no_grad():
        for key, spec in reader:
            if spec.ndim == 3:
                spec = spec[0]
            feats, t_orig = pad_to_bucket(
                spec.astype(np.float32)[None], axis=1, bucket=64)
            mask = model(torch.from_numpy(feats).to(device))[0, :t_orig]
            writer.write(key, mask.cpu().numpy().astype(np.float32))
            num_done += 1
    logger.info(f"Processed {num_done} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Run a trained neural mask estimator",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("wav_scp", help="Input (mono) wave scripts")
    parser.add_argument("checkpoint", help="Trained checkpoint path")
    parser.add_argument("dst_dir", help="Output directory (.npy masks)")
    parser.add_argument("--scp", default="")
    parser.add_argument("--device", default="cuda",
                        help="Where the model runs (cuda or cpu)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
