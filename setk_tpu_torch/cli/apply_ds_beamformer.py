#!/usr/bin/env python
"""Delay-and-sum beamformer (a thin wrapper over apply_classic_beamformer).

The port's counterpart of ``setk_tpu/cli/apply_ds_beamformer.py``:
apply_classic_beamformer's flags, ``--device`` included, with
``--beamformer ds``.
"""

from setk_tpu_torch.cli import apply_classic_beamformer as classic


def make_parser():
    parser = classic.make_parser()
    parser.description = "Delay-and-sum beamformer"
    return parser


def run(args):
    args.beamformer = "ds"
    classic.run(args)


if __name__ == "__main__":
    run(make_parser().parse_args())
