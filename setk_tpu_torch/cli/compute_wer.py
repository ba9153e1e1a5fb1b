#!/usr/bin/env python
"""Permutation WER over Kaldi-format transcripts.

The port's counterpart of ``setk_tpu/cli/compute_wer.py``, with the same
flags.  Edit distances run on the host, as in the JAX package, so the
command takes no ``--device``.

    python -m setk_tpu_torch.cli compute_wer hyp.txt ref.txt
"""

import argparse
from collections import defaultdict

from setk_tpu_torch.io import parse_scps
from setk_tpu_torch.metrics import permute_ed
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class TransReader:
    """Multi-speaker transcription reader (comma-separated scps)."""

    def __init__(self, text):
        self.readers = [
            parse_scps(t, num_tokens=-1, restrict=False)
            for t in text.split(",")
        ]

    def __len__(self):
        return len(self.readers)

    def __contains__(self, key):
        return all(key in r for r in self.readers)

    def __getitem__(self, key):
        def tokens(val):
            return val if isinstance(val, list) else [val]

        return [tokens(reader[key]) for reader in self.readers]

    def __iter__(self):
        for key in self.readers[0]:
            if key in self:
                yield key, self[key]


def run(args):
    hyp_reader = TransReader(args.hyp)
    ref_reader = TransReader(args.ref)
    if len(hyp_reader) != len(ref_reader):
        raise RuntimeError("Speaker count mismatch between hyp & ref")
    utt2class = parse_scps(args.utt2class) if args.utt2class else None
    each_utt = open(args.per_utt, "w") if args.per_utt else None
    err = defaultdict(float)
    tot = defaultdict(float)
    cnt = 0
    for key, hyp in hyp_reader:
        ref = ref_reader[key]
        dist = permute_ed(hyp, ref)
        ref_len = sum(len(r) for r in ref)
        if each_utt:
            each_utt.write(f"{key}\t{dist / ref_len:.3f}\n" if ref_len
                           else f"{key}\tINF\n")
        cls = utt2class[key] if utt2class else "all"
        err[cls] += dist
        tot[cls] += ref_len
        cnt += 1
    if each_utt:
        each_utt.close()
    sum_err, sum_len = sum(err.values()), sum(tot.values())
    print(f"Total WER: {sum_err * 100 / sum_len:.2f}%, {cnt} utterances")
    if len(err) != 1:
        for cls in err:
            print(f"  {cls}: {err[cls] * 100 / tot[cls]:.2f}%")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute permutation WER over Kaldi-format transcripts",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("hyp", help="Hypotheses (multi-speaker: a,b)")
    parser.add_argument("ref", help="References (multi-speaker: a,b)")
    parser.add_argument("--per-utt", default="",
                        help="Dump per-utterance WER here")
    parser.add_argument("--utt2class", default="",
                        help="Per-class reporting map")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
