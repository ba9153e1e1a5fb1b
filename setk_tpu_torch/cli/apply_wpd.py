#!/usr/bin/env python
"""Factored WPD (joint dereverberation and denoising) over an scp corpus.

The port's counterpart of ``setk_tpu/cli/apply_wpd.py``: the enhanced
wave per key and, with ``--mask-dir``, the estimated T-F mask (.npy,
T x F), with ``--device`` (``cuda`` by default, ``cpu`` for the plain
path).  One utterance a call.  On the card ``wpd`` takes its fused path
(kernels 18 -> 17 -> 19 for the WPE step, 15 for the CGMM, 12 for the
covariances and 2 for the MVDR weights, each once an outer iteration);
outside the fused gate it needs an EVD on the card and refuses (ROADMAP
queue 1 item 13).  ``--device cpu`` runs the scan that the JAX CLI runs
on its host.  An utterance whose output is not finite is skipped with a
warning.

    python -m setk_tpu_torch.cli apply_wpd wav.scp out/ --mask-dir masks/
"""

import argparse

import numpy as np

from setk_tpu_torch.cli.common import (StftParser, stft_config_from_args,
                                       strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance.wpe import wpd
from setk_tpu_torch.io import NumpyWriter, SpectrogramReader, WaveWriter
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    mask_writer = NumpyWriter(args.mask_dir) if args.mask_dir else None
    num_done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        if mask_writer:
            mask_writer.__enter__()
        for key, stft_mat in reader:
            obs = stft_mat.transpose(1, 0, 2).astype(np.complex64)  # F N T
            # wpd refuses what the card does not run before the copy
            mask, enh = wpd(obs, cgmm_iters=args.cgmm_iters,
                            wpd_iters=args.wpd_iters, taps=args.taps,
                            delay=args.delay, context=args.context,
                            update_alpha=args.update_alpha, device=device)
            samps = inverse_stft(enh.transpose(0, 1), cfg,
                                 nsamps=reader.nsamps(key)).cpu().numpy()
            if not np.isfinite(samps).all():
                logger.warning(f"{key}: non-finite output, skipping")
                continue
            writer.write(key, samps)
            if mask_writer:
                mask_writer.write(key, mask.cpu().numpy().T.astype(
                    np.float32))
            num_done += 1
    if mask_writer:
        mask_writer.__exit__()
    logger.info(f"Processed {num_done} utterances over {len(reader)} "
                f"({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Factored WPD: joint dereverberation & denoising",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--mask-dir", default="",
                        help="Also dump estimated T-F masks (.npy)")
    parser.add_argument("--taps", type=int, default=10)
    parser.add_argument("--delay", type=int, default=3)
    parser.add_argument("--context", type=int, default=1)
    parser.add_argument("--cgmm-iters", type=int, default=10)
    parser.add_argument("--wpd-iters", type=int, default=3)
    parser.add_argument("--update-alpha", type=strtobool, default=False)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (the kernels) or cpu "
                        "(the plain path)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
