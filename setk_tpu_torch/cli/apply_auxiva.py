#!/usr/bin/env python
"""AuxIVA blind source separation.

The port's counterpart of ``setk_tpu/cli/apply_auxiva.py``, with the same
flags and ``--device`` (``cuda`` by default, ``cpu`` for the plain
path): each utterance's multi-channel STFT (the reader's, on the host)
goes to that device, where the separation (kernel 13 once an epoch for
every four sources) and each source's inverse STFT run.

    python -m setk_tpu_torch.cli apply_auxiva wav.scp out/ --epochs 20
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance.auxiva import auxiva
from setk_tpu_torch.io import SpectrogramReader
from setk_tpu_torch.io.wave import write_wav
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg)  # N x T x F
    for key, spectra in reader:
        logger.info(f"Processing utterance {key}...")
        separated = auxiva(torch.from_numpy(spectra.astype(np.complex64)),
                           epochs=args.epochs, device=device)
        norm = reader.maxabs(key)
        for idx in range(separated.shape[0]):
            samps = inverse_stft(separated[idx], cfg, norm=float(norm))
            write_wav(Path(args.dst_dir) / f"{key}.src{idx + 1}.wav",
                      samps.cpu().numpy(), sr=args.sr)
    logger.info(f"Processed {len(reader)} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="AuxIVA blind source separation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
