#!/usr/bin/env python
"""T-F mask separation: mask x STFT -> iSTFT.

The port's counterpart of ``setk_tpu/cli/wav_separate.py``, with the same
flags (optional phase reference, mixed-norm, keep-length) and
``--device`` (``cuda`` by default, ``cpu`` for the plain path): each
utterance's spectrum and mask go to that device, the masking and the
inverse STFT run there.

    python -m setk_tpu_torch.cli wav_separate wav.scp mask.scp out/ \\
        --fmt numpy [--phase-ref ref.scp]
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.io import MaskReader, SpectrogramReader, WaveWriter
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _first_channel(spec):
    return spec[0] if spec.ndim == 3 else spec


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    mask_reader = MaskReader(args.fmt, args.mask_scp)
    phase_reader = None
    if args.phase_ref:
        phase_reader = SpectrogramReader(args.phase_ref, cfg=cfg,
                                         transpose=False)
    num_done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, stft_mat in reader:
            if key not in mask_reader:
                logger.warning(f"Missing mask for utterance {key}")
                continue
            norm = reader.maxabs(key) if args.mixed_norm else None
            mask = np.asarray(mask_reader[key])
            spectra = _first_channel(stft_mat)
            # masks arrive T x F (or F x T): align to F x T
            if mask.shape == spectra.shape[::-1]:
                mask = mask.T
            if mask.shape != spectra.shape:
                raise RuntimeError(
                    f"Mask/spectrogram mismatch: {mask.shape} vs "
                    f"{spectra.shape}")
            spectra = torch.from_numpy(spectra).to(device)
            if phase_reader is not None:
                pha = torch.from_numpy(_first_channel(
                    phase_reader[key])).to(device)
                spectra = spectra.abs() * torch.exp(1j * pha.angle())
            enh = spectra * torch.from_numpy(
                np.ascontiguousarray(mask)).to(device, torch.float32)
            nsamps = reader.nsamps(key) if args.keep_length else None
            samps = inverse_stft(enh.T, cfg, nsamps=nsamps, norm=norm)
            writer.write(key, samps.cpu().numpy())
            num_done += 1
    logger.info(f"Processed {num_done} utterances over {len(reader)} "
                f"({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Separate target component via T-F masks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Mixture wave scripts")
    parser.add_argument("mask_scp", help="T-F mask scripts")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--fmt", default="kaldi",
                        choices=["kaldi", "numpy", "exraw"])
    parser.add_argument("--phase-ref", default="",
                        help="Use phase from this wave script instead")
    parser.add_argument("--mixed-norm", "--use-mixed-norm",
                        dest="mixed_norm", type=strtobool, default=True,
                        help="Normalize output peak to the mixture's")
    parser.add_argument("--keep-length", type=strtobool, default=True)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
