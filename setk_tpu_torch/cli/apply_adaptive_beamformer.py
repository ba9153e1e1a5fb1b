#!/usr/bin/env python
"""Mask-based adaptive beamforming (mvdr/mpdr/mpdr-whiten/gevd/pmwf-0/1)
over an scp corpus.

The port's counterpart of ``setk_tpu/cli/apply_adaptive_beamformer.py``,
with the same flags, on ``--device`` (``cuda`` by default; ``cpu`` runs
the plain path).  Outputs are renormalized to the input's peak and
non-finite ones skipped.

The per-utterance path (``--batch-size 1``, the default) is the JAX CLI's
``_run`` step by step: the spectrogram reader's STFT on the host, the
masks turned T x F, the VAD filter (``--vad-proportion``), frames padded
to a bucket of 64 (or the chunk size) with the noise mask made after the
padding, ``supervised_run`` (interference masks, ``--pmwf-ref``,
``--rank1-appro``, ``--ban``) or ``online_supervised_run``
(``--chunk-size``, ``--alpha``) and the post-mask, then the iSTFT.  On
the card the covariances run kernels 12 and 13 and every EVD the EVD
kernel (ops/cuda/eigh_small.hermitian_eigh).

The batched path (``--batch-size`` > 1, without the interference, VAD
and post-mask options) runs the native prefetching wav loader and
``BatchEnhancer``, offline or online; on the card ``--frame-len``,
``--frame-hop`` and ``--center`` choose the kernels as ``enhance_batch``
does.

    python -m setk_tpu_torch.cli apply_adaptive_beamformer wav.scp \\
        mask.scp out/ [--beamformer gevd --ban true] [--chunk-size 32]
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, pad_to_bucket,
                                       refuse_data_parallel,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance.vad import apply_vad_filter, vad_masks
from setk_tpu_torch.io import MaskReader, SpectrogramReader, WaveWriter
from setk_tpu_torch.io.prefetch import PrefetchWaveLoader
from setk_tpu_torch.parallel.executor import BatchEnhancer
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger
from setk_tpu_torch.utils.profiling import ThroughputMeter, trace

logger = get_logger(__name__)

BEAMFORMERS = ["mvdr", "mpdr", "mpdr-whiten", "gevd", "pmwf-0", "pmwf-1"]


def _check_args(args):
    """Refuse what the chosen path does not take, before any file is
    read; returns the device."""
    device = resolve_device(args.device)
    refuse_data_parallel(args.data_parallel, device)
    if args.batch_size > 1 and (args.itf_mask or
                                0.5 < args.vad_proportion < 1 or args.mask):
        raise RuntimeError(
            "--batch-size > 1 supports the offline and online "
            "paths (no interference/VAD/post-mask options)")
    return device


def _enhance(args, cfg, device, obs, m_s, m_n, nsamps):
    """One utterance: obs (F, N, T) complex64, masks (F, T) -> samples."""
    obs, m_s, m_n = (torch.from_numpy(x).to(device) for x in (obs, m_s, m_n))
    if args.chunk_size > 0:
        enh = bf.online_supervised_run(args.beamformer, obs, m_s,
                                       mask_n=m_n,
                                       chunk_size=args.chunk_size,
                                       alpha=args.alpha, ban=bool(args.ban))
    else:
        kwargs = {}
        if args.beamformer.startswith("pmwf"):
            kwargs = dict(ref_channel=args.pmwf_ref,
                          rank1_appro=args.rank1_appro)
        enh = bf.supervised_run(args.beamformer, obs, m_s, mask_n=m_n,
                                ban=bool(args.ban), **kwargs)
    if args.mask:
        enh = enh * m_s
    return inverse_stft(enh.transpose(-1, -2), cfg,
                        nsamps=nsamps).cpu().numpy()


def _run_utterances(args, device):
    """The per-utterance path, the host steps of the JAX CLI's ``_run``
    (setk_tpu/cli/apply_adaptive_beamformer.py:121-191) in its order:
    the outputs depend on them (the padded frames count in Rn's mask sum,
    which scales gevd's and PMWF's weights)."""
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    tgt_reader = MaskReader(args.fmt, args.tgt_mask)
    itf_reader = MaskReader(args.fmt, args.itf_mask) if args.itf_mask \
        else None
    bucket = args.chunk_size if args.chunk_size > 0 else 64
    full_f32_matmuls(device)
    num_done = 0
    meter = ThroughputMeter("adaptive-beamformer", report_every=100)
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, stft_mat in reader:
            if key not in tgt_reader:
                continue
            norm = reader.maxabs(key)
            # stft_mat: N x F x T
            f_bins = stft_mat.shape[1]
            speech_mask = np.asarray(tgt_reader[key])
            interf_mask = np.asarray(itf_reader[key]) if itf_reader else None
            if interf_mask is None:
                speech_mask = np.minimum(speech_mask, 1)
            # ensure T x F orientation
            if speech_mask.shape[0] == f_bins and \
                    speech_mask.shape[1] != f_bins:
                speech_mask = speech_mask.T
                if interf_mask is not None:
                    interf_mask = interf_mask.T
            if 0.5 < args.vad_proportion < 1:
                silence, n_filtered = vad_masks(stft_mat[0],
                                                args.vad_proportion)
                logger.info(f"Filtering {int(n_filtered)} TF-masks...")
                speech_mask = apply_vad_filter(speech_mask, silence).numpy()
                if interf_mask is not None:
                    interf_mask = apply_vad_filter(interf_mask,
                                                   silence).numpy()
            obs = stft_mat.transpose(1, 0, 2).astype(np.complex64)
            m_s = np.ascontiguousarray(speech_mask.T).astype(np.float32)
            obs, _ = pad_to_bucket(obs, axis=-1, bucket=bucket)
            m_s, _ = pad_to_bucket(m_s, axis=-1, bucket=bucket)
            if interf_mask is not None:
                m_n = np.ascontiguousarray(interf_mask.T).astype(np.float32)
                m_n, _ = pad_to_bucket(m_n, axis=-1, bucket=bucket)
            else:
                # after the padding: padded frames carry m_n = 1
                m_n = np.maximum(1.0 - m_s, 0.0)
            samps = _enhance(args, cfg, device, obs, m_s, m_n,
                             reader.nsamps(key))
            if not np.isfinite(samps).all():
                # degenerate covariance: the reference skips the
                # utterance on a failed solve
                logger.warning(f"{key}: non-finite output, skipping")
                continue
            peak = np.max(np.abs(samps))
            samps = samps * norm / (peak + 1e-7)
            writer.write(key, samps)
            meter.update(samps.shape[-1] / args.sr)
            num_done += 1
    meter.report()
    logger.info(f"Processed {num_done} utterances out of {len(reader)} "
                f"({device})")


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
        if args.batch_size > 1:
            _run_batched(args, device)
        else:
            _run_utterances(args, device)


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
                        help="Interference masks (optional)")
    parser.add_argument("--sr", "--sample-rate", dest="sr",
                        type=int, default=16000)
    parser.add_argument("--ban", type=strtobool, default=False,
                        help="Blind analytic normalization")
    parser.add_argument("--mask", "--post-masking", dest="mask",
                        type=strtobool, default=False,
                        help="Mask the beamformer output")
    parser.add_argument("--vad-proportion", type=float, default=1.0,
                        help="Energy proportion for VAD mask filtering")
    parser.add_argument("--pmwf-ref", type=int, default=-1,
                        help="PMWF reference channel (-1: by SNR)")
    parser.add_argument("--rank1-appro", default="",
                        choices=["", "eig", "gev"])
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
                        "executor (offline and online paths)")
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
