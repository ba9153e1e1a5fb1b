#!/usr/bin/env python
"""Superdirective beamformer (a thin wrapper over apply_classic_beamformer).

The port's counterpart of ``setk_tpu/cli/apply_sd_beamformer.py``:
apply_classic_beamformer's flags, ``--device`` included, with
``--beamformer sd``.
"""

from setk_tpu_torch.cli import apply_classic_beamformer as classic


def make_parser():
    parser = classic.make_parser()
    parser.description = "Superdirective beamformer (diffuse noise field)"
    return parser


def run(args):
    args.beamformer = "sd"
    classic.run(args)


if __name__ == "__main__":
    run(make_parser().parse_args())
