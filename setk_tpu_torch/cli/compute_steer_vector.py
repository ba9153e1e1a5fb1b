#!/usr/bin/env python
"""Compute a steering grid (A x M x F .npy) for linear or circular arrays.

The port's counterpart of ``setk_tpu/cli/compute_steer_vector.py``, with
the same flags (linear arrays sample 0-180 degrees, circular 0-360) and
``--device``.  The grid is built on the host in float64 and cast to
complex64 at the end whatever the device, so the file is bit-equal to
the JAX CLI's; ``--device`` is checked as every command of the port
checks it.

    python -m setk_tpu_torch.cli compute_steer_vector sv.npy \\
        --geometry circular --num-doas 360
"""

import argparse

import numpy as np

from setk_tpu_torch.cli.common import add_device_flag, strtobool
from setk_tpu_torch.spatial.steer import steer_vector_grid
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    resolve_device(args.device)
    topo = [float(t) for t in args.linear_topo.split(",")] \
        if args.linear_topo else None
    doas, grid = steer_vector_grid(
        args.geometry, args.num_doas, args.num_bins,
        linear_topo=topo,
        circular_radius=args.circular_radius,
        circular_around=args.circular_around,
        circular_center=args.circular_center,
        c=args.speed, sr=args.sr)
    # grid: A x F x N -> A x M x F
    out = np.ascontiguousarray(grid.transpose(0, 2, 1))
    np.save(args.dst, out)
    logger.info(f"Steering grid {out.shape} ({args.geometry}, "
                f"{doas[0]:.1f}..{doas[-1]:.1f} deg) -> {args.dst}")


def make_parser():
    parser = argparse.ArgumentParser(
        description="Compute steering vectors over a DoA grid",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("dst", help="Output .npy (A x M x F)")
    parser.add_argument("--geometry", default="linear",
                        choices=["linear", "circular"])
    parser.add_argument("--num-doas", type=int, default=181)
    parser.add_argument("--num-bins", type=int, default=257)
    parser.add_argument("--linear-topo", default="0,0.05,0.1,0.15")
    parser.add_argument("--circular-radius", type=float, default=0.05)
    parser.add_argument("--circular-around", type=int, default=6)
    parser.add_argument("--circular-center", type=strtobool, default=False)
    parser.add_argument("--speed", type=float, default=340)
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
