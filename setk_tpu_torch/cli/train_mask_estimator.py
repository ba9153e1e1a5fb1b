#!/usr/bin/env python
"""Train a neural T-F mask estimator (DNN/TDNN/CNN-TDNN/LSTM/BLSTM).

The port's counterpart of ``setk_tpu/cli/train_mask_estimator.py``:
features are log-magnitude spectrograms, targets oracle masks
(compute_mask), objective the quadratic loss, utterances cut or
zero-padded to ``--frames-per-utt`` frames with a frame mask, shuffled
each epoch by ``numpy.random.default_rng(seed)`` as the JAX CLI does.
``--device`` is ``cuda`` by default (a BLSTM's recurrence runs kernels 20
and 21 there; ``--hidden`` above 1024 refuses there, naming ROADMAP queue
1 item 16) or ``cpu``; ``--data-parallel`` over more than one card
waits for ROADMAP queue 1 item 12.  The checkpoint is the JAX package's
format (flax msgpack plus ``.json`` meta), so ``setk_tpu``'s
``estimate_nn_masks`` reads it.

    python -m setk_tpu_torch.cli train_mask_estimator noisy.scp \\
        target.scp final.msgpack --arch blstm --epochs 10
"""

import argparse

import numpy as np

from setk_tpu_torch.cli.common import (StftParser, refuse_data_parallel,
                                       stft_config_from_args)
from setk_tpu_torch.io import MaskReader, SpectrogramReader
from setk_tpu_torch.models.mask_net import ARCHS, make_model
from setk_tpu_torch.models.trainer import MaskTrainer, save_checkpoint
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _batches(reader, mask_reader, keys, batch_size, t_bucket=256):
    feats, targets, masks = [], [], []
    for key in keys:
        if key not in mask_reader:
            continue
        spec = reader[key]  # T x F (mono) log-magnitude
        if spec.ndim == 3:
            spec = spec[0]
        target = np.asarray(mask_reader[key])
        if target.shape != spec.shape:
            target = target.T
        t = min(spec.shape[0], t_bucket)
        f = spec.shape[1]
        feat = np.zeros((t_bucket, f), dtype=np.float32)
        tgt = np.zeros((t_bucket, f), dtype=np.float32)
        fm = np.zeros((t_bucket,), dtype=np.float32)
        feat[:t] = spec[:t]
        tgt[:t] = np.clip(target[:t], 0, 1)
        fm[:t] = 1.0
        feats.append(feat)
        targets.append(tgt)
        masks.append(fm)
        if len(feats) == batch_size:
            yield (np.stack(feats), np.stack(targets), np.stack(masks))
            feats, targets, masks = [], [], []
    if feats:
        yield (np.stack(feats), np.stack(targets), np.stack(masks))


def run(args):
    device = resolve_device(args.device)
    refuse_data_parallel(args.data_parallel, device)
    cfg = stft_config_from_args(args)
    model = make_model(arch=args.arch, num_bins=cfg.num_bins,
                       hidden=args.hidden, num_layers=args.num_layers)
    trainer = MaskTrainer(model, lr=args.lr, seed=args.seed, device=device)
    reader = SpectrogramReader(args.wav_scp, cfg=cfg, apply_abs=True,
                               apply_log=True)
    mask_reader = MaskReader(args.fmt, args.mask_scp)
    keys = list(reader.keys())
    rng = np.random.default_rng(args.seed)
    for epoch in range(args.epochs):
        rng.shuffle(keys)
        losses = [trainer.train_batch(*batch) for batch in _batches(
            reader, mask_reader, keys, args.batch_size, args.frames_per_utt)]
        logger.info(f"Epoch {epoch + 1}/{args.epochs}: "
                    f"loss = {np.mean(losses):.5f} "
                    f"({len(losses)} batches, {device})")
    save_checkpoint(args.checkpoint, trainer.model.state_dict(), {
        "arch": args.arch,
        "num_bins": cfg.num_bins,
        "hidden": args.hidden,
        "num_layers": args.num_layers,
        "frame_len": cfg.frame_len,
        "frame_hop": cfg.frame_hop,
        "window": cfg.window,
        "center": cfg.center,
        "round_power_of_two": cfg.round_power_of_two,
    })


def make_parser():
    parser = argparse.ArgumentParser(
        description="Train a neural T-F mask estimator",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        parents=[StftParser.parser])
    parser.add_argument("wav_scp", help="Noisy (mono) wave scripts")
    parser.add_argument("mask_scp", help="Target mask scripts")
    parser.add_argument("checkpoint", help="Output checkpoint path")
    parser.add_argument("--fmt", default="kaldi",
                        choices=["kaldi", "numpy", "exraw"])
    parser.add_argument("--arch", default="dnn", choices=list(ARCHS))
    parser.add_argument("--hidden", type=int, default=512)
    parser.add_argument("--num-layers", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--frames-per-utt", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--data-parallel", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="Where the model trains (cuda or cpu)")
    return parser


if __name__ == "__main__":
    run(make_parser().parse_args())
