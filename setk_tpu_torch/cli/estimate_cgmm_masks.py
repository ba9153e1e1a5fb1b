#!/usr/bin/env python
"""Unsupervised CGMM mask estimation over an scp corpus.

The port's counterpart of ``setk_tpu/cli/estimate_cgmm_masks.py``, with
the same flags and outputs (one .npy mask per key, the speech class for
K = 2, K x T x F otherwise) and ``--device`` (``cuda`` by default, ``cpu``
for the plain path).  ``--batch-size`` > 1 runs ``BatchClusterer`` over
frame buckets: on the card one launch of the fused EM kernel a bucket.
``--batch-size 1`` runs each utterance on its own, with ``--init-mask``,
``--dump-model`` (.npz files interchangeable with the JAX CLI's) and
``--resume-model`` (the scan: the masked covariance and Jacobi inverse
kernels once an iteration on the card).

    python -m setk_tpu_torch.cli estimate_cgmm_masks wav.scp masks/ \\
        --batch-size 16
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, stft_config_from_args,
                                       strtobool)
from setk_tpu_torch.convert import em_state_from_numpy, em_state_to_numpy
from setk_tpu_torch.enhance.cluster import cgmm_em, permu_aligner
from setk_tpu_torch.io import NumpyWriter, ScriptReader, SpectrogramReader
from setk_tpu_torch.parallel.executor import BatchClusterer
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def load_state(resume_dir, key, device):
    """The EM state saved for ``key`` under ``resume_dir``, or None."""
    if not resume_dir:
        return None
    mdl = Path(resume_dir) / f"{key}.npz"
    if not mdl.exists():
        return None
    with np.load(mdl) as loaded:
        state = {k: loaded[k] for k in loaded.files}
    logger.info(f"Resumed EM state from {mdl}")
    return em_state_from_numpy(state, device)


def dump_state(dump_dir, key, state):
    if dump_dir:
        mdl_dir = Path(dump_dir)
        mdl_dir.mkdir(parents=True, exist_ok=True)
        np.savez(mdl_dir / f"{key}.npz", **em_state_to_numpy(state))


def log_q(key, q_hist, num_iters):
    for i, q in enumerate(q_hist.cpu().numpy()):
        logger.info(f"{key}: iter {i + 1:2d}/{num_iters}: Q = {q:.4f}")


def _run(args, device):
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    init_reader = ScriptReader(args.init_mask) if args.init_mask else None
    num_done = 0
    with NumpyWriter(args.dst_dir, args.scp) as writer:
        dst_dir = Path(args.dst_dir)
        for key, stft_mat in reader:
            if not args.force and (dst_dir / f"{key}.npy").exists():
                logger.info(f"Skip existing {key}.npy...")
                continue
            # N x F x T -> F x N x T
            obs = torch.from_numpy(
                stft_mat.transpose(1, 0, 2).astype(np.complex64)).to(device)
            gamma_init = None
            if init_reader is not None and key in init_reader:
                init = np.asarray(init_reader[key])  # T x F
                gamma_init = np.stack([init.T, 1 - init.T]).astype(
                    np.float32)  # K x F x T
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed)
            gamma, q_hist, state = cgmm_em(
                obs, args.num_classes, num_iters=args.num_iters,
                gamma_init=gamma_init, update_alpha=args.update_alpha,
                generator=gen, state=load_state(args.resume_model, key,
                                                device),
                return_state=True)
            dump_state(args.dump_model, key, state)
            log_q(key, q_hist, args.num_iters)
            masks = gamma.cpu().numpy().transpose(0, 2, 1)  # K x T x F
            if args.solve_permu and args.num_classes > 2:
                masks = permu_aligner(masks)
            if args.num_classes == 2:
                # the speech class (sample-covariance init) comes first
                writer.write(key, masks[0].astype(np.float32))
            else:
                writer.write(key, masks.astype(np.float32))
            num_done += 1
    logger.info(f"Processed {num_done} utterances ({device})")


def run_batched(args, device, algo, **em_kwargs):
    """Bucketed multi-utterance EM through BatchClusterer on ``device``."""
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    clusterer = BatchClusterer(algo=algo, num_classes=args.num_classes,
                               num_iters=args.num_iters,
                               batch_size=args.batch_size, seed=args.seed,
                               device=device,
                               update_alpha=args.update_alpha, **em_kwargs)
    num_done = 0
    with NumpyWriter(args.dst_dir, args.scp) as writer:
        def emit(key, gamma):
            masks = np.ascontiguousarray(gamma.transpose(0, 2, 1))
            if args.solve_permu and args.num_classes > 2:
                masks = permu_aligner(masks)
            if args.num_classes == 2 and algo == "cgmm":
                writer.write(key, masks[0].astype(np.float32))
            else:
                writer.write(key, masks.astype(np.float32))

        for key, stft_mat in reader:
            obs = stft_mat.transpose(1, 0, 2).astype(np.complex64)
            for done_key, gamma in clusterer.add(key, obs):
                emit(done_key, gamma)
                num_done += 1
        for done_key, gamma in clusterer.flush():
            emit(done_key, gamma)
            num_done += 1
    logger.info(f"Processed {num_done} utterances (batched, {device})")


def run(args):
    device = resolve_device(args.device)
    if args.batch_size > 1:
        run_batched(args, device, "cgmm")
    else:
        _run(args, device)


def make_parser():
    parser = argparse.ArgumentParser(
        description="Estimate T-F masks via CGMM spatial clustering",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dst_dir", help="Output directory for .npy masks")
    parser.add_argument("--scp", default="", help="Also emit an index scp")
    parser.add_argument("--num-classes", type=int, default=2)
    parser.add_argument("--num-iters", type=int, default=20)
    parser.add_argument("--init-mask", default="",
                        help="Initial speech masks (kaldi scp)")
    parser.add_argument("--update-alpha", type=strtobool, default=False)
    parser.add_argument("--solve-permu", type=strtobool, default=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=1,
                        help=">1 runs bucketed multi-utterance EM "
                        "(frame-masked statistics)")
    parser.add_argument("--dump-model", default="",
                        help="Directory to save per-utt EM model state (.npz)")
    parser.add_argument("--resume-model", default="",
                        help="Directory with saved EM states to resume from")
    parser.add_argument("--force", type=strtobool, default=False,
                        help="Recompute even if output exists")
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (the kernels) or cpu "
                        "(the plain path)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
