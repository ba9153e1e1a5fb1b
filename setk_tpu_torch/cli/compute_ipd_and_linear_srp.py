#!/usr/bin/env python
"""Spatial features (SRP-PHAT / IPD / MSC) for linear arrays -> archives.

The port's counterpart of ``setk_tpu/cli/compute_ipd_and_linear_srp.py``,
with the same flags and ``--device`` (``cuda`` by default, ``cpu`` for
the plain path): each utterance's STFT goes to that device and its
features are computed there.

    python -m setk_tpu_torch.cli compute_ipd_and_linear_srp wav.scp \\
        ipd.ark --type ipd --ipd.pair "0,1;0,2"
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.io import ArchiveWriter, SpectrogramReader
from setk_tpu_torch.spatial.features import (ipd, msc,
                                             smooth_angular_spectrogram,
                                             srp_phat_linear)
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def compute_spatial_feats(args, cfg, spectra):
    """srp (T, D), ipd (T, P F or 2 P F) or msc (T, F) of an (N, T, F)
    STFT."""
    if args.type == "srp":
        topo = [float(t) for t in args.linear_topo.split(",")]
        srp = srp_phat_linear(spectra, topo,
                              sample_frequency=args.samp_frequency,
                              num_doa=args.num_doa,
                              num_bins=cfg.num_bins,
                              samp_doa=not args.samp_tdoa)
        return smooth_angular_spectrogram(srp, args.smooth_context)
    if args.type == "ipd":
        if spectra.ndim < 3:
            raise ValueError("IPD needs multi-channel STFT")
        feats = []
        for pair in args.ipd_pair.split(";"):
            left, right = map(int, pair.split(","))
            feats.append(ipd(spectra[left], spectra[right],
                             cos=args.ipd_cos, sin=args.ipd_sin))
        return torch.cat(feats, dim=-1)
    return msc(spectra, context=args.msc_ctx)


def run(args):
    device = resolve_device(args.device)
    full_f32_matmuls(device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg)  # N x T x F
    num_done = 0
    with ArchiveWriter(args.dup_ark, args.scp) as writer:
        for key, spectra in reader:
            feats = compute_spatial_feats(
                args, cfg, torch.from_numpy(spectra).to(device))
            writer.write(key, feats.cpu().numpy().astype(np.float32))
            num_done += 1
            if num_done % 1000 == 0:
                logger.info(f"Processed {num_done} utterances...")
    logger.info(f"Processed {num_done} utterances over {len(reader)} "
                f"({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute spatial features (srp/ipd/msc)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dup_ark", help="Output archive")
    parser.add_argument("--scp", default="")
    parser.add_argument("--type", default="srp",
                        choices=["srp", "ipd", "msc"])
    parser.add_argument("--linear-topo", dest="linear_topo",
                        default="0,0.05,0.1,0.15")
    parser.add_argument("--srp.num-doa", dest="num_doa", type=int,
                        default=181)
    parser.add_argument("--srp.samp-tdoa", dest="samp_tdoa",
                        type=strtobool, default=False)
    parser.add_argument("--srp.samp-frequency", dest="samp_frequency",
                        type=int, default=16000)
    parser.add_argument("--srp.smooth-context", "--smooth-context",
                        dest="smooth_context", type=int, default=0,
                        help="Temporal context for angular-spectrogram "
                        "averaging (0 disables)")
    parser.add_argument("--ipd.pair", dest="ipd_pair", default="0,1",
                        help="Mic pairs, e.g. '0,1;1,2'")
    parser.add_argument("--ipd.cos", dest="ipd_cos", type=strtobool,
                        default=False)
    parser.add_argument("--ipd.sin", dest="ipd_sin", type=strtobool,
                        default=False)
    parser.add_argument("--msc.ctx", dest="msc_ctx", type=int, default=1)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
