#!/usr/bin/env python
"""Classic DS/SD beamforming for linear and circular arrays.

The port's counterpart of ``setk_tpu/cli/apply_classic_beamformer.py``,
with the same flags (a fixed DoA or a per-utterance one, ``--utt2doa``;
online chunked DoA tracks, ``--chunk-len``) and ``--device`` (``cuda``
by default, ``cpu`` for the plain path).  Steer vectors and the diffuse
covariance are built on the host in float64 and cast to complex64 (the
JAX CLI's grids, bit for bit); the weights, the beamform and the inverse
STFT run on the device.  Superdirective weights solve against a diffuse
field loaded with 0.1 I on a line and 1e-5 I on a circle, whose low bins
are badly conditioned (a condition number near 6e5 at bins 0-1 for the
default 6-mic circle).

    python -m setk_tpu_torch.cli apply_classic_beamformer wav.scp out/ \\
        --beamformer sd --geometry circular --doa 120
"""

import argparse
import math

import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, strtobool)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.io import ScpReader, SpectrogramReader, WaveWriter
from setk_tpu_torch.spatial.steer import (circular_distance_matrix,
                                          circular_steer_vector,
                                          diffuse_covar,
                                          linear_distance_matrix,
                                          linear_steer_vector)
from setk_tpu_torch.utils.common import check_doa
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def make_weight_fn(args, num_bins, device):
    """doa (degrees) -> (F, N) complex64 weights on ``device`` for the
    configured array."""
    if args.geometry == "linear":
        topo = [float(t) for t in args.linear_topo.split(",")]
        dist_mat = linear_distance_matrix(topo)
        diag_eps = 0.1

        def steer(doa):
            return linear_steer_vector(topo, doa, num_bins, c=args.speed,
                                       sr=args.sr)
        num_mics = len(topo)
    else:
        dist_mat = circular_distance_matrix(args.circular_radius,
                                            args.circular_around,
                                            center=args.circular_center)
        diag_eps = 1e-5

        def steer(doa):
            return circular_steer_vector(args.circular_radius,
                                         args.circular_around, doa, num_bins,
                                         c=args.speed, sr=args.sr,
                                         center=args.circular_center)
        num_mics = args.circular_around + (1 if args.circular_center else 0)

    def steer_on(doa):
        return torch.from_numpy(steer(doa)).to(device)

    if args.beamformer == "ds":
        return lambda doa: bf.ds_weights(steer_on(doa), num_mics)
    rn = torch.from_numpy(diffuse_covar(num_bins, dist_mat, sr=args.sr,
                                        c=args.speed,
                                        diag_eps=diag_eps)).to(device)
    return lambda doa: bf.sd_weights(steer_on(doa) / num_mics, rn)


def parse_doa(args, online):
    if args.utt2doa:
        proc = (lambda d: [float(v) for v in d]) if online else \
            (lambda d: float(d[0] if isinstance(d, list) else d))
        reader = ScpReader(args.utt2doa, value_processor=proc,
                           num_tokens=-1, restrict=False)
        logger.info(f"Use --utt2doa={args.utt2doa} per utterance")
        return reader.get
    doa = [float(v) for v in str(args.doa).split(",")] if online \
        else float(args.doa)
    logger.info(f"Use --doa={args.doa} for all utterances")
    return lambda _: doa


def run(args):
    device = resolve_device(args.device)
    full_f32_matmuls(device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, transpose=False)
    weight_fn = make_weight_fn(args, cfg.num_bins, device)
    online = args.chunk_len > 0
    utt2doa = parse_doa(args, online)
    done = 0
    with WaveWriter(args.dst_dir, sr=args.sr) as writer:
        for key, stft_src in reader:
            doa = utt2doa(key)
            if doa is None:
                logger.info(f"Missing doa for utterance {key}")
                continue
            if not check_doa(args.geometry, doa, online):
                logger.info(f"Invalid doa {doa} for utterance {key}")
                continue
            # N x F x T -> F x N x T
            obs = torch.from_numpy(stft_src).to(device).transpose(0, 1)
            if online:
                num_chunks = math.ceil(obs.shape[-1] / args.chunk_len)
                if len(doa) != num_chunks:
                    logger.info(f"Invalid chunk count for {key}: "
                                f"{len(doa)} vs {num_chunks}")
                    continue
                enh = torch.cat([
                    bf.beamform(weight_fn(d), obs[..., c * args.chunk_len:
                                                  (c + 1) * args.chunk_len])
                    for c, d in enumerate(doa)], dim=-1)
            else:
                enh = bf.beamform(weight_fn(doa), obs)
            norm = reader.maxabs(key) if args.normalize else None
            samps = inverse_stft(enh.T, cfg, norm=norm)
            writer.write(key, samps.cpu().numpy())
            done += 1
    logger.info(f"Processed {done} utterances over {len(reader)} ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Classic DS/SD beamformers (linear/circular arrays)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--beamformer", default="ds", choices=["ds", "sd"])
    parser.add_argument("--geometry", default="linear",
                        choices=["linear", "circular"])
    parser.add_argument("--linear-topo", default="0,0.05,0.1,0.15",
                        help="Linear mic positions (meters)")
    parser.add_argument("--circular-radius", type=float, default=0.05)
    parser.add_argument("--circular-around", type=int, default=6)
    parser.add_argument("--circular-center", type=strtobool, default=False)
    parser.add_argument("--doa", default="90",
                        help="DoA in degrees (list when online)")
    parser.add_argument("--utt2doa", default="",
                        help="Per-utterance DoA script")
    parser.add_argument("--chunk-len", type=int, default=-1,
                        help=">0 enables online chunked DoA tracks")
    parser.add_argument("--speed", type=float, default=340)
    parser.add_argument("--normalize", type=strtobool, default=True)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
