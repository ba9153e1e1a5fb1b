#!/usr/bin/env python
"""BSS-eval SDR evaluation (the port's own bss_eval, no mir_eval).

The port's counterpart of ``setk_tpu/cli/compute_sdr.py``, with the same
flags.  The decomposition runs on the host in float64 numpy and scipy,
as in the JAX package, so the command takes no ``--device``.

    python -m setk_tpu_torch.cli compute_sdr est1.scp,est2.scp ref1.scp,ref2.scp
"""

import argparse
from collections import defaultdict

import numpy as np

from setk_tpu_torch.io import WaveReader, parse_scps
from setk_tpu_torch.metrics import bss_eval_sdr
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    est_readers = [WaveReader(s, sr=None) for s in args.est_scp.split(",")]
    ref_readers = [WaveReader(s, sr=None) for s in args.ref_scp.split(",")]
    if len(est_readers) != len(ref_readers):
        raise RuntimeError("est/ref script count mismatch")
    utt2class = parse_scps(args.utt2class) if args.utt2class else None
    reports = defaultdict(list)
    for key in est_readers[0].keys():
        if not all(key in r for r in est_readers + ref_readers):
            continue
        est = np.stack([r[key] for r in est_readers])
        ref = np.stack([r[key] for r in ref_readers])
        n = min(est.shape[-1], ref.shape[-1])
        sdr, _ = bss_eval_sdr(est[..., :n], ref[..., :n])
        score = float(np.mean(sdr))
        if args.details:
            print(f"{key} {score:.2f}")
        cls = utt2class[key] if utt2class else "all"
        reports[cls].append(score)
    for cls, scores in sorted(reports.items()):
        logger.info(f"{cls}: SDR = {np.mean(scores):.3f} dB over "
                    f"{len(scores)} utterances")
    total = [s for v in reports.values() for s in v]
    print(f"SDR: {np.mean(total):.3f} dB over {len(total)} utterances")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute BSS-eval SDR",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("est_scp", help="Estimates (comma-separated)")
    parser.add_argument("ref_scp", help="References (comma-separated)")
    parser.add_argument("--utt2class", default="")
    parser.add_argument("--details", action="store_true")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
