#!/usr/bin/env python
"""Single-channel noise suppression (OM-LSA, MCRA/iMCRA).

The port's counterpart of ``setk_tpu/cli/apply_ns.py``, with the same
flags (a YAML file of estimator options, gain or wave output) and
``--device`` (``cuda`` by default, ``cpu`` for the plain path).  Each
utterance's STFT (the reader's, on the host) goes to that device; the
gain is one launch of the OM-LSA kernel there, and the wave output's
inverse STFT runs there too.

    python -m setk_tpu_torch.cli apply_ns wav.scp out/ --estimator imcra
"""

import argparse

import numpy as np
import torch

from setk_tpu_torch.cli.common import (StftParser, add_device_flag,
                                       stft_config_from_args)
from setk_tpu_torch.dsp.stft import inverse_stft
from setk_tpu_torch.enhance.ns import (IMCRAConfig, MCRAConfig, imcra_gain,
                                       mcra_gain)
from setk_tpu_torch.io import NumpyWriter, SpectrogramReader, WaveWriter
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def run(args):
    device = resolve_device(args.device)
    cfg = stft_config_from_args(args)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg)  # T x F
    conf = {}
    if args.conf:
        import yaml
        with open(args.conf) as f:
            conf = yaml.safe_load(f) or {}
    if args.estimator == "mcra":
        ns_cfg = MCRAConfig(**conf)
        gain_fn = lambda s: mcra_gain(s, ns_cfg)
    else:
        ns_cfg = IMCRAConfig(**conf)
        gain_fn = lambda s: imcra_gain(s, ns_cfg)
    writer_cls = NumpyWriter if args.output == "gain" else WaveWriter
    writer_args = {} if args.output == "gain" else {"sr": args.sr}
    done = 0
    with writer_cls(args.dst_dir, **writer_args) as writer:
        for key, spectra in reader:
            if spectra.ndim == 3:
                spectra = spectra[0]
            spec = torch.from_numpy(spectra.astype(np.complex64)).to(device)
            gain = gain_fn(spec)
            if args.output == "gain":
                writer.write(key, gain.cpu().numpy().astype(np.float32))
            else:
                samps = inverse_stft(spec * gain, cfg,
                                     nsamps=reader.nsamps(key))
                writer.write(key, samps.cpu().numpy())
            done += 1
    logger.info(f"Processed {done} utterances ({device})")


def make_parser():
    parser = argparse.ArgumentParser(
        description="OM-LSA noise suppression (MCRA/iMCRA estimators)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Noisy wave scripts")
    parser.add_argument("dst_dir", help="Output directory")
    parser.add_argument("--estimator", default="imcra",
                        choices=["mcra", "imcra"])
    parser.add_argument("--conf", default="",
                        help="YAML file of estimator options")
    parser.add_argument("--output", default="wave",
                        choices=["wave", "gain"])
    parser.add_argument("--sr", type=int, default=16000)
    return add_device_flag(parser)


if __name__ == "__main__":
    run(make_parser().parse_args())
