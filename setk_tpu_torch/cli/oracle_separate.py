#!/usr/bin/env python
"""Oracle multi-speaker separation with ideal masks from references.

The port's counterpart of ``setk_tpu/cli/oracle_separate.py``, with the
same flags (iam/ibm/irm/psm masks over per-speaker reference scps,
``--cutoff``, ``--mixed-norm``) and ``--device`` (``cuda`` by default,
``cpu`` for the plain path): the masks and the inverse STFTs of each
utterance run there.

    python -m setk_tpu_torch.cli oracle_separate mix.scp spk1.scp,spk2.scp \\
        out/ --mask irm
"""

import argparse

import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance.masks import compute_mask
from setk_tpu_torch.io import SpectrogramReader, WaveWriter
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def oracle_masks(mix, refs, mask, cutoff=-1):
    """(S, F, T) masks of the references ``refs`` (S, F, T) in the
    mixture ``mix`` (F, T): irm and ibm from the references' magnitudes
    alone, iam and psm against the mixture, clipped to [0, cutoff]."""
    if mask in ("irm", "ibm"):
        mags = refs.abs()
        if mask == "irm":
            return mags / torch.clamp(mags.sum(0), min=1e-7)
        return (mags == mags.amax(0, keepdim=True)).float()
    masks = compute_mask(refs, mix, mask)
    if cutoff > 0:
        masks = torch.clamp(masks, max=cutoff)
    return torch.clamp(masks, min=0)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    mix_reader = SpectrogramReader(args.mix_scp, cfg=cfg, transpose=False)
    ref_readers = [
        SpectrogramReader(scp, cfg=cfg, transpose=False)
        for scp in args.ref_scp.split(",")
    ]
    num_done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, mix in mix_reader:
            if not all(key in r for r in ref_readers):
                logger.warning(f"Missing references for utterance {key}")
                continue
            mix0 = torch.from_numpy(mix[0] if mix.ndim == 3 else mix).to(
                device)
            refs = torch.stack([torch.from_numpy(
                r[key][0] if r[key].ndim == 3 else r[key])
                for r in ref_readers]).to(device)
            norm = mix_reader.maxabs(key) if args.mixed_norm else None
            masks = oracle_masks(mix0, refs, args.mask, args.cutoff)
            samps = inverse_stft((mix0 * masks).transpose(-1, -2), cfg,
                                 nsamps=mix_reader.nsamps(key), norm=norm)
            for idx, s in enumerate(samps.cpu().numpy()):
                writer.write(f"{key}.spk{idx + 1}", s)
            num_done += 1
    logger.info(f"Processed {num_done} utterances over {len(mix_reader)} "
                f"({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Oracle speaker separation via ideal masks",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("mix_scp", help="Mixture wave scripts")
    parser.add_argument("ref_scp",
                        help="Comma-separated per-speaker reference scps")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--mask", default="irm",
                        choices=["iam", "ibm", "irm", "psm"])
    parser.add_argument("--cutoff", type=float, default=-1)
    parser.add_argument("--mixed-norm", type=strtobool, default=True)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
