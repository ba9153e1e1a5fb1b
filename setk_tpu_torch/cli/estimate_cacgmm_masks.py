#!/usr/bin/env python
"""Unsupervised CACGMM mask estimation over an scp corpus.

The port's counterpart of ``setk_tpu/cli/estimate_cacgmm_masks.py``, with
the same flags and outputs (K x T x F .npy masks) and ``--device``
(``cuda`` by default, ``cpu`` for the plain path).  ``--batch-size`` > 1
runs ``BatchClusterer`` (on the card one launch of the fused EM kernel a
bucket) unless ``--init-mask`` is given; ``--batch-size 1`` runs each
utterance on its own, with ``--init-mask``, ``--dump-model`` and
``--resume-model`` as in ``estimate_cgmm_masks``.  The default random
init draws from a torch generator: other numbers than the JAX CLI's
``jax.random`` init from the same ``--seed``.

    python -m setk_tpu_torch.cli estimate_cacgmm_masks wav.scp masks/ \\
        --batch-size 16 --cgmm-init true
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, stft_config_from_args,
                                       strtobool)
from setk_tpu_torch.cli.estimate_cgmm_masks import (dump_state, load_state,
                                                    log_q, run_batched)
from setk_tpu_torch.enhance.cluster import cacgmm_em, permu_aligner
from setk_tpu_torch.io import MaskReader, NumpyWriter, SpectrogramReader
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _run(args, device):
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    init_reader = (MaskReader(args.fmt, args.init_mask)
                   if args.init_mask else None)
    num_done = 0
    with NumpyWriter(args.dst_dir, args.scp) as writer:
        dst_dir = Path(args.dst_dir)
        for key, stft_mat in reader:
            if not args.force and (dst_dir / f"{key}.npy").exists():
                logger.info(f"Skip existing {key}.npy...")
                continue
            obs = torch.from_numpy(
                stft_mat.transpose(1, 0, 2).astype(np.complex64)).to(device)
            gamma_init = None
            if init_reader is not None and key in init_reader:
                # K x T x F, or T x F for the speech class of two
                im = np.asarray(init_reader[key])
                if im.ndim == 2:
                    im = np.stack([im, 1.0 - im])
                gamma_init = np.transpose(im, (0, 2, 1))
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed)
            gamma, q_hist, state = cacgmm_em(
                obs, args.num_classes, num_iters=args.num_iters,
                gamma_init=gamma_init, cgmm_init=args.cgmm_init,
                update_alpha=args.update_alpha, generator=gen,
                state=load_state(args.resume_model, key, device),
                return_state=True)
            dump_state(args.dump_model, key, state)
            log_q(key, q_hist, args.num_iters)
            masks = gamma.cpu().numpy().transpose(0, 2, 1)  # K x T x F
            if args.solve_permu:
                masks = permu_aligner(masks)
            writer.write(key, masks.astype(np.float32))
            num_done += 1
    logger.info(f"Processed {num_done} utterances ({device})")


def run(args):
    device = resolve_device(args.device)
    if args.batch_size > 1 and not args.init_mask:
        run_batched(args, device, "cacgmm", cgmm_init=args.cgmm_init)
        return
    if args.batch_size > 1:
        logger.info("--init-mask given: using the per-utterance path")
    _run(args, device)


def make_parser():
    parser = argparse.ArgumentParser(
        description="Estimate T-F masks via CACGMM spatial clustering",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dst_dir", help="Output directory for .npy masks")
    parser.add_argument("--scp", default="", help="Also emit an index scp")
    parser.add_argument("--num-classes", type=int, default=2)
    parser.add_argument("--num-iters", type=int, default=20)
    parser.add_argument("--cgmm-init", type=strtobool, default=False)
    parser.add_argument("--update-alpha", type=strtobool, default=True)
    parser.add_argument("--solve-permu", type=strtobool, default=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=1,
                        help=">1 runs bucketed multi-utterance EM "
                        "(frame-masked statistics)")
    parser.add_argument("--dump-model", default="",
                        help="Directory to save per-utt EM model state (.npz)")
    parser.add_argument("--resume-model", default="",
                        help="Directory with saved EM states to resume from")
    parser.add_argument("--force", type=strtobool, default=False)
    parser.add_argument("--init-mask", default="",
                        help="Initial speech masks to seed the EM "
                        "(K x T x F, or T x F for 2 classes)")
    parser.add_argument("--fmt", "--mask-format", dest="fmt",
                        default="numpy", choices=["numpy", "kaldi"],
                        help="Initial-mask container format")
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (the kernels) or cpu "
                        "(the plain path)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
