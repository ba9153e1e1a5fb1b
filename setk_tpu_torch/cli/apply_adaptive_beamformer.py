#!/usr/bin/env python
"""Mask-based adaptive beamforming (mvdr/mpdr/mpdr-whiten/gevd/pmwf-0/1)
over an scp corpus.

The port's counterpart of ``setk_tpu/cli/apply_adaptive_beamformer.py``,
with the same flags.  It runs the batched path (``--batch-size`` > 1):
the native prefetching wav loader, the mask reader, ``BatchEnhancer`` on
``--device`` (``cuda`` by default; ``cpu`` runs the plain path), offline
or online (``--chunk-size`` > 0), and the wav writer, with the output
peak renormalized to the input's and non-finite outputs skipped.  On the
card, ``--frame-len``, ``--frame-hop`` and ``--center`` choose the
kernels as ``enhance_batch`` does: the fused kernels for the 512/256
center geometry, the planar kernels for mvdr at other n_fft = 2 hop
powers of two from 256 to 2048 (with or without center), and the
spectrum-domain run (the pair-covariance kernel and the per-bin solves)
for the rest of mvdr, mvdr with BAN and pmwf-0/1; gevd, mpdr and
mpdr-whiten outside the fused geometry, and online outside it, raise
naming their ROADMAP item before the batch reaches the card.  The
per-utterance path (``--batch-size 1`` and its options: interference
masks, VAD filtering, post-masking, the PMWF reference channel and
rank-1 approximation) comes with ROADMAP queue 1 item 14.

    python -m setk_tpu_torch.cli apply_adaptive_beamformer wav.scp \\
        mask.scp out/ --batch-size 64 [--chunk-size 32 --alpha 0.8]
"""

import argparse

import numpy as np

from setk_tpu_torch.cli.common import (StftParser, refuse_data_parallel,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.io import MaskReader, WaveWriter
from setk_tpu_torch.io.prefetch import PrefetchWaveLoader
from setk_tpu_torch.parallel.executor import BatchEnhancer
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger
from setk_tpu_torch.utils.profiling import ThroughputMeter, trace

logger = get_logger(__name__)

BEAMFORMERS = ["mvdr", "mpdr", "mpdr-whiten", "gevd", "pmwf-0", "pmwf-1"]


def _check_args(args):
    """Refuse what the port does not run yet, before any file is read."""
    per_utt = [flag for flag, on in (
        ("--batch-size 1", args.batch_size <= 1),
        ("--itf-mask", bool(args.itf_mask)),
        ("--vad-proportion", 0.5 < args.vad_proportion < 1),
        ("--mask", bool(args.mask)),
        ("--pmwf-ref", args.pmwf_ref != -1),
        ("--rank1-appro", bool(args.rank1_appro))) if on]
    if per_utt:
        raise NotImplementedError(
            f"{', '.join(per_utt)}: the per-utterance path arrives with "
            f"ROADMAP queue 1 item 14; the port runs --batch-size > 1 "
            f"(offline and online) without these options")
    device = resolve_device(args.device)
    refuse_data_parallel(args.data_parallel, device)
    return device


def _run_batched(args, device):
    """Bucketed (B, N, S) batches through BatchEnhancer on ``device``."""
    cfg = stft_config_from_args(args)
    enhancer = BatchEnhancer(cfg, beamformer=args.beamformer,
                             batch_size=args.batch_size,
                             ban=bool(args.ban),
                             chunk_size=args.chunk_size, alpha=args.alpha,
                             device=device)
    # decode-ahead on the native thread pool so the card never waits on IO
    reader = PrefetchWaveLoader(args.wav_scp, sr=args.sr)
    tgt_reader = MaskReader(args.fmt, args.tgt_mask)
    num_done = 0
    meter = ThroughputMeter("adaptive-beamformer[batched]", report_every=64)
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        norms = {}

        def emit(key, samps):
            if not np.isfinite(samps).all():
                # degenerate covariance: the reference skips the
                # utterance on a failed solve
                logger.warning(f"{key}: non-finite output, skipping")
                return
            peak = np.max(np.abs(samps))
            writer.write(key, samps * norms[key] / (peak + 1e-7))
            meter.update(samps.shape[-1] / args.sr)

        for key, wav in reader:
            if key not in tgt_reader:
                continue
            if wav.ndim == 1:
                wav = wav[None]
            mask = np.asarray(tgt_reader[key])
            f_bins = cfg.num_bins
            if mask.shape[0] == f_bins and mask.shape[1] != f_bins:
                mask = mask.T  # to T x F
            norms[key] = float(np.max(np.abs(wav)))
            for done_key, samps in enhancer.add(
                    key, wav.astype(np.float32),
                    np.minimum(mask, 1).astype(np.float32)):
                emit(done_key, samps)
                num_done += 1
        for done_key, samps in enhancer.flush():
            emit(done_key, samps)
            num_done += 1
    meter.report()
    logger.info(f"Processed {num_done} utterances (batched, {device})")


def run(args):
    device = _check_args(args)
    with trace(args.profile_dir):
        _run_batched(args, device)


def make_parser():
    parser = argparse.ArgumentParser(
        description="Run adaptive (mvdr/gevd/pmwf) beamformer",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("tgt_mask", help="Target speech masks (scp/dir)")
    parser.add_argument("dst_dir", help="Output directory for wavs")
    parser.add_argument("--beamformer", default="mvdr", choices=BEAMFORMERS)
    parser.add_argument("--fmt", "--mask-format", dest="fmt",
                        default="numpy",
                        choices=["numpy", "kaldi", "exraw"],
                        help="Mask storage format")
    parser.add_argument("--itf-mask", default="",
                        help="Interference masks (per-utterance path)")
    parser.add_argument("--sr", "--sample-rate", dest="sr",
                        type=int, default=16000)
    parser.add_argument("--ban", type=strtobool, default=False,
                        help="Blind analytic normalization")
    parser.add_argument("--mask", "--post-masking", dest="mask",
                        type=strtobool, default=False,
                        help="Mask the beamformer output (per-utterance "
                        "path)")
    parser.add_argument("--vad-proportion", type=float, default=1.0,
                        help="Energy proportion for VAD mask filtering "
                        "(per-utterance path)")
    parser.add_argument("--pmwf-ref", type=int, default=-1,
                        help="PMWF reference channel (-1: by SNR; others "
                        "per-utterance path)")
    parser.add_argument("--rank1-appro", default="",
                        choices=["", "eig", "gev"],
                        help="Rank-1 approximation (per-utterance path)")
    parser.add_argument("--chunk-size", "--online.chunk-size",
                        dest="chunk_size", type=int, default=-1,
                        help=">0 enables online chunked processing")
    parser.add_argument("--alpha", "--online.alpha", dest="alpha",
                        type=float, default=0.8,
                        help="Online covariance EMA factor")
    parser.add_argument("--channels", "--online.channels",
                        dest="channels", type=int, default=4,
                        help="(accepted for recipe compatibility)")
    parser.add_argument("--batch-size", type=int, default=1,
                        help=">1 runs bucketed batches through the "
                        "executor (the path the port runs)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Shard batches over the cards (one card: "
                        "no-op)")
    parser.add_argument("--device", default="cuda",
                        help="Where to run: cuda (the kernels) or cpu "
                        "(the plain path)")
    parser.add_argument("--profile-dir", "--jax-profile-dir",
                        dest="profile_dir", default="",
                        help="Write a torch profiler Chrome trace of the "
                        "run to this directory")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
