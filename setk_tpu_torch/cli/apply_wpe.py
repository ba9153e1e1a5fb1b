#!/usr/bin/env python
"""WPE dereverberation over an scp corpus.

The port's counterpart of ``setk_tpu/cli/apply_wpe.py``, with the same
flags and outputs and ``--device`` (``cuda`` by default, ``cpu`` for the
plain path).  ``--batch-size`` > 1 runs ``BatchWpe`` over sample buckets;
``--batch-size 1`` runs each utterance's STFT (frames padded to a multiple
of 64) on its own.  On the card both take the fused kernels 18 -> 17 per
iteration and 19 at the end where N <= 8 and N taps <= 128, else the
tap-matrix scan with kernel 16.  An utterance whose output is not finite
is skipped with a warning, as the reference skips a failed solve.

    python -m setk_tpu_torch.cli apply_wpe wav.scp out/ --batch-size 16
"""

import argparse

import numpy as np

from setk_tpu_torch.cli.common import (StftParser, pad_to_bucket,
                                       refuse_data_parallel,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance.wpe import wpe
from setk_tpu_torch.io import SpectrogramReader, WaveWriter
from setk_tpu_torch.io.prefetch import PrefetchWaveLoader
from setk_tpu_torch.parallel.executor import BatchWpe
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _run_batched(args, device):
    """Bucketed (B, N, S) batches through BatchWpe on ``device``."""
    cfg = stft_config_from_args(args)
    reader = PrefetchWaveLoader(args.wav_scp, sr=args.sr)
    executor = BatchWpe(cfg, taps=args.taps, delay=args.delay,
                        context=args.context, num_iters=args.num_iters,
                        batch_size=args.batch_size, device=device)
    num_done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:

        def emit(key, samps):
            nonlocal num_done
            if not np.isfinite(samps).all():
                logger.warning(f"{key}: non-finite output, skipping")
                return
            writer.write(key, samps)
            num_done += 1

        for key, wav in reader:
            if wav.ndim == 1:
                wav = wav[None]
            for done_key, samps in executor.add(key,
                                                wav.astype(np.float32)):
                emit(done_key, samps)
        for done_key, samps in executor.flush():
            emit(done_key, samps)
    logger.info(f"Processed {num_done} utterances (batched, {device})")


def _run(args, device):
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    num_done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, stft_mat in reader:
            if stft_mat.ndim == 2:
                stft_mat = stft_mat[None]
            obs = stft_mat.transpose(1, 0, 2).astype(np.complex64)  # F N T
            obs, _ = pad_to_bucket(obs, axis=-1, bucket=64)
            der = wpe(obs, taps=args.taps, delay=args.delay,
                      context=args.context, num_iters=args.num_iters,
                      device=device)
            samps = inverse_stft(der.permute(1, 2, 0), cfg,
                                 nsamps=reader.nsamps(key)).cpu().numpy()
            if not np.isfinite(samps).all():
                # singular tap correlation: the reference skips on a
                # failed solve
                logger.warning(f"{key}: non-finite output, skipping")
                continue
            writer.write(key, samps)
            num_done += 1
            if num_done % 100 == 0:
                logger.info(f"Processed {num_done} utterances...")
    logger.info(f"Processed {num_done} utterances over {len(reader)} "
                f"({device})")


def run(args):
    device = resolve_device(args.device)
    refuse_data_parallel(args.data_parallel, device)
    if args.batch_size > 1:
        _run_batched(args, device)
    else:
        _run(args, device)


def make_parser():
    parser = argparse.ArgumentParser(
        description="WPE dereverberation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--taps", type=int, default=10)
    parser.add_argument("--delay", type=int, default=3)
    parser.add_argument("--context", type=int, default=1)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--sr", "--sample-rate", dest="sr",
                        type=int, default=16000)
    parser.add_argument("--nara-wpe", type=strtobool,
                        default=False,
                        help="Accepted for reference-CLI "
                        "compatibility: the built-in WPE "
                        "already implements the same GWPE "
                        "recursion (nara_wpe wpe_v6/v8)")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="Bucketed batch execution (throughput path)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batches over several cards (ROADMAP "
                        "queue 1 item 12; one card runs as without it)")
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (the kernels) or cpu "
                        "(the plain path)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
