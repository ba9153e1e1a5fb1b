#!/usr/bin/env python
"""Reconstruct waveforms from (log/pow) magnitude features.

The port's counterpart of ``setk_tpu/cli/wav_estimate.py``: a reference
phase where ``--phase-ref`` gives one, else Griffin-Lim, with the same
flags and ``--device`` (``cuda`` by default, ``cpu`` for the plain
path): the magnitudes (and the reference phase) go to that device, where
the inverse STFT or the Griffin-Lim loop runs.  Griffin-Lim starts from
a seeded CPU generator's phase, so both devices start alike; it is not
the phase the JAX command draws (ROADMAP queue 3).

    python -m setk_tpu_torch.cli wav_estimate feats.scp out/ [--phase-ref wav.scp]
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.griffin_lim import griffin_lim
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.io import ScriptReader, SpectrogramReader, WaveWriter
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    feat_reader = ScriptReader(args.feat_scp)
    phase_reader = None
    if args.phase_ref:
        phase_reader = SpectrogramReader(args.phase_ref, cfg=cfg,
                                         transpose=False)
    num_done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, feat in feat_reader:
            mag = np.asarray(feat, dtype=np.float32)  # T x F
            if args.apply_log:
                mag = np.exp(mag)
            if args.apply_pow:
                mag = np.sqrt(np.maximum(mag, 0))
            mag = torch.from_numpy(np.ascontiguousarray(mag)).to(device)
            if phase_reader is not None and key in phase_reader:
                pha = phase_reader[key]
                pha = pha[0] if pha.ndim == 3 else pha  # F x T
                pha = torch.from_numpy(np.ascontiguousarray(
                    pha[:, :mag.shape[0]].T)).to(device)
                samps = inverse_stft(mag * torch.exp(1j * pha.angle()), cfg)
            else:
                samps = griffin_lim(mag, cfg, key=0, epochs=args.gl_epochs)
            writer.write(key, samps.cpu().numpy())
            num_done += 1
    logger.info(f"Processed {num_done} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Estimate waveforms from spectral magnitudes",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("feat_scp", help="Magnitude feature scripts (kaldi)")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--phase-ref", default="",
                        help="Wave script providing phases")
    parser.add_argument("--apply-log", type=strtobool, default=False,
                        help="Features are log magnitudes")
    parser.add_argument("--apply-pow", type=strtobool, default=False,
                        help="Features are power spectra")
    parser.add_argument("--gl-epochs", type=int, default=30,
                        help="Griffin-Lim iterations")
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
