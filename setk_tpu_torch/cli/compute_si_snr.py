#!/usr/bin/env python
"""Si-SNR (Si-SDR) evaluation with permutation alignment and a per-class
report.

The port's counterpart of ``setk_tpu/cli/compute_si_snr.py``, with the
same flags and ``--device`` (``cuda`` by default, ``cpu`` for the plain
path): each utterance's estimates and references go to that device,
where the scores are computed.

    python -m setk_tpu_torch.cli compute_si_snr est.scp ref.scp
"""

import argparse
from collections import defaultdict

import numpy as np
import torch

from setk_tpu_torch.cli.common import add_device_flag
from setk_tpu_torch.io import WaveReader, parse_scps
from setk_tpu_torch.metrics import permute_si_snr, si_snr
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    single = "," not in args.est_scp
    if single:
        est_readers = [WaveReader(args.est_scp, sr=None)]
        ref_readers = [WaveReader(args.ref_scp, sr=None)]
    else:
        est_readers = [WaveReader(s, sr=None)
                       for s in args.est_scp.split(",")]
        ref_readers = [WaveReader(s, sr=None)
                       for s in args.ref_scp.split(",")]
        if len(est_readers) != len(ref_readers):
            raise RuntimeError("est/ref script count mismatch")
    utt2class = parse_scps(args.utt2class) if args.utt2class else None
    reports = defaultdict(list)

    def on_device(samps):
        return torch.from_numpy(np.ascontiguousarray(samps)).to(device)

    for key in est_readers[0].keys():
        if not all(key in r for r in est_readers + ref_readers):
            continue
        est = [r[key] for r in est_readers]
        ref = [r[key] for r in ref_readers]
        n = min(min(e.shape[-1] for e in est),
                min(r.shape[-1] for r in ref))
        est = [on_device(e[..., :n]) for e in est]
        ref = [on_device(r[..., :n]) for r in ref]
        if single:
            score = float(si_snr(est[0], ref[0]))
        else:
            score = permute_si_snr(est, ref, align=args.align)
            if args.align:
                score = score[0]
        cls = utt2class[key] if utt2class else "all"
        reports[cls].append(score)
        if args.details:
            print(f"{key} {score:.2f}")
    for cls, scores in sorted(reports.items()):
        logger.info(f"{cls}: Si-SNR = {np.mean(scores):.3f} dB "
                    f"over {len(scores)} utterances")
    total = [s for v in reports.values() for s in v]
    print(f"Si-SNR: {np.mean(total):.3f} dB over {len(total)} utterances")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute Si-SNR between estimated and reference signals",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("est_scp",
                        help="Estimates (comma-separated for multi-source)")
    parser.add_argument("ref_scp",
                        help="References (comma-separated for multi-source)")
    parser.add_argument("--utt2class", default="",
                        help="Per-class reporting map")
    parser.add_argument("--align", action="store_true",
                        help="Use the best permutation (multi-source)")
    parser.add_argument("--details", action="store_true",
                        help="Print per-utterance scores")
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
