#!/usr/bin/env python
"""Sound-source localization (ml/srp/music backends) over an scp corpus.

The port's counterpart of ``setk_tpu/cli/do_ssl.py``, with the same flags
(a precomputed steering grid, A x M x F .npy; winner-take-all over
several masks; online chunked DoA tracks with look-back) and
``--device`` (``cuda`` by default, ``cpu`` for the plain path).  The
grid, each utterance's STFT and its mask lie on that device; online
tracking runs one localization a chunk, as the JAX CLI does.  On the
card music's per-bin EVD is one launch of the EVD kernel a call.

    python -m setk_tpu_torch.cli do_ssl wav.scp sv.npy doa.scp \\
        --backend music --doa-range 0,360 [--chunk-len 32]
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args, str2tuple)
from setk_tpu_torch.io import NumpyReader, SpectrogramReader
from setk_tpu_torch.spatial.ssl import ml_ssl, music_ssl, srp_ssl
from setk_tpu_torch.utils.common import EPSILON
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def add_wta(masks_list, eps=1e-4):
    """Winner-take-all across per-source masks."""
    masks = np.stack(masks_list, axis=-1)
    max_mask = np.max(masks, -1)
    return [np.where(m == max_mask, m, eps) for m in masks_list]


def get_doa(stft, steer_vector, mask, srp_pair, angles, output, backend):
    if srp_pair:
        idx = int(srp_ssl(stft, steer_vector, srp_pair, mask=mask))
    elif backend == "ml":
        idx = int(ml_ssl(stft, steer_vector, mask=mask, compression=-1,
                         eps=EPSILON))
    else:
        idx = int(music_ssl(stft, steer_vector, mask=mask))
    return idx if output == "index" else angles[idx]


def run(args):
    device = resolve_device(args.device)
    full_f32_matmuls(device)
    cfg = stft_config_from_args(args)
    steer_vector = torch.from_numpy(np.load(args.steer_vector)).to(device)
    logger.info(f"Shape of the steer vector: {tuple(steer_vector.shape)}")
    num_doa = steer_vector.shape[0]
    min_doa, max_doa = str2tuple(args.doa_range)
    if args.output == "radian":
        angles = np.linspace(min_doa * np.pi / 180, max_doa * np.pi / 180,
                             num_doa + 1)
    else:
        angles = np.linspace(min_doa, max_doa, num_doa + 1)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg)  # M x T x F
    mask_readers = [NumpyReader(scp) for scp in args.mask_scp.split(",")] \
        if args.mask_scp else None
    online = args.chunk_len > 0 and args.look_back > 0
    srp_pair = None
    if args.backend == "srp":
        pairs = [tuple(map(int, p.split(","))) for p in
                 args.srp_pair.split(";")]
        srp_pair = ([t[0] for t in pairs], [t[1] for t in pairs])
        logger.info(f"SRP backend, pair: {srp_pair}")

    with open(args.doa_scp, "w") as doa_out:
        for key, stft in reader:
            f_bins = stft.shape[-1]
            mask = None
            if mask_readers:
                masks = [np.asarray(r[key]) for r in mask_readers]
                if args.mask_eps >= 0 and len(masks) > 1:
                    masks = add_wta(masks, eps=args.mask_eps)
                mask = masks[0]
                if mask.shape[-1] != f_bins:
                    mask = mask.T
                mask = torch.from_numpy(np.ascontiguousarray(mask)).to(
                    device, torch.float32)
            stft = torch.from_numpy(stft).to(device)
            if not online:
                doa = get_doa(stft, steer_vector, mask, srp_pair, angles,
                              args.output, args.backend)
                logger.info(f"Processing utterance {key}: {doa:.4f}")
                doa_out.write(f"{key}\t{doa:.4f}\n")
            else:
                t_frames = stft.shape[1]
                track = []
                for t in range(0, t_frames, args.chunk_len):
                    s = max(t - args.look_back, 0)
                    chunk_mask = mask[s:t + args.chunk_len] \
                        if mask is not None else None
                    chunk = stft[:, s:t + args.chunk_len, :]
                    track.append(
                        get_doa(chunk, steer_vector, chunk_mask, srp_pair,
                                angles, args.output, args.backend))
                doa_out.write(
                    f"{key}\t{' '.join(f'{d:.4f}' for d in track)}\n")
    logger.info(f"Processed {len(reader)} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="ML/SRP/MUSIC sound source localization",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Multi-channel wave scripts")
    parser.add_argument("steer_vector",
                        help="Steering grid .npy (A x M x F)")
    parser.add_argument("doa_scp", help="Output utt2doa script")
    parser.add_argument("--backend", default="ml",
                        choices=["ml", "srp", "music"])
    parser.add_argument("--doa-range", default="0,180",
                        help="DoA range covered by the steering grid")
    parser.add_argument("--output", default="degree",
                        choices=["degree", "radian", "index"])
    parser.add_argument("--mask-scp", default="",
                        help="Comma-separated T-F mask scripts")
    parser.add_argument("--mask-eps", type=float, default=-1,
                        help=">=0 enables winner-take-all masking")
    parser.add_argument("--srp-pair", default="",
                        help="Mic pairs for srp, e.g. '0,3;1,4;2,5'")
    parser.add_argument("--chunk-len", type=int, default=-1)
    parser.add_argument("--look-back", type=int, default=125)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
