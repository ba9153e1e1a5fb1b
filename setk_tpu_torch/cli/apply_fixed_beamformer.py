#!/usr/bin/env python
"""Apply pre-designed fixed beam weights (F x N, or B x F x N + a beam index).

The port's counterpart of ``setk_tpu/cli/apply_fixed_beamformer.py``,
with the same flags (``--beam``, ``--utt2beam``, ``--normalize``) and
``--device`` (``cuda`` by default, ``cpu`` for the plain path): the
weights lie on that device, and each utterance's beamform and inverse
STFT run there.

    python -m setk_tpu_torch.cli apply_fixed_beamformer wav.scp w.npy \\
        out/ --utt2beam utt2beam
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.io import ScpReader, SpectrogramReader, WaveWriter
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    weights = np.load(args.weights)
    if weights.ndim not in (2, 3):
        raise RuntimeError(f"Expect 2/3D weights, got {weights.ndim}D")
    weights = torch.from_numpy(weights.astype(np.complex64)).to(device)
    utt2beam = None
    if args.utt2beam:
        utt2beam = ScpReader(args.utt2beam, value_processor=int).get
    done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, stft_mat in reader:
            if weights.ndim == 3:
                beam = utt2beam(key) if utt2beam else args.beam
                if beam is None or beam >= weights.shape[0]:
                    logger.warning(f"Invalid beam index for {key}")
                    continue
                w = weights[beam]
            else:
                w = weights
            # N x F x T -> F x N x T
            obs = torch.from_numpy(stft_mat).to(device).transpose(0, 1)
            enh = bf.beamform(w, obs)
            norm = reader.maxabs(key) if args.normalize else None
            samps = inverse_stft(enh.T, cfg, norm=norm)
            writer.write(key, samps.cpu().numpy())
            done += 1
    logger.info(f"Processed {done} utterances over {len(reader)} ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Apply fixed beamformer weights",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("weights", help=".npy weights, F x N or B x F x N")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--beam", type=int, default=0,
                        help="Beam index for 3D weights")
    parser.add_argument("--utt2beam", default="",
                        help="Per-utterance beam index script")
    parser.add_argument("--normalize", type=strtobool, default=True)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
