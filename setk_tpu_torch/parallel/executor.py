"""Batched, bucketed utterance execution.

Counterpart of ``setk_tpu/parallel/executor.py``: ``shard_manifest``
(deterministic manifest sharding across processes), ``LengthBucketer``
(padded shape buckets) and ``BatchEnhancer``, which assembles
(B, N, S) batches and (B, T, F) masks per bucket, runs
``enhance_batch`` on them and returns per-utterance trimmed waveforms.
Data parallelism over a device mesh comes with ROADMAP queue 1 item 12;
the clustering and WPE executors with queue 1 items 6 and 7.
"""

from collections import defaultdict

import numpy as np
import torch

from setk_tpu_torch.dsp.stft import StftConfig, num_frames
from setk_tpu_torch.parallel.enhance_step import enhance_batch
from setk_tpu_torch.utils.device import resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

__all__ = ["shard_manifest", "LengthBucketer", "BatchEnhancer"]


def shard_manifest(keys, num_shards: int, shard_index: int):
    """Deterministic contiguous sharding of a key list (split_scp.pl)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"Bad shard {shard_index}/{num_shards}")
    keys = list(keys)
    base, extra = divmod(len(keys), num_shards)
    beg = shard_index * base + min(shard_index, extra)
    end = beg + base + (1 if shard_index < extra else 0)
    return keys[beg:end]


class LengthBucketer:
    """Round sample lengths up to hop-aligned buckets."""

    def __init__(self, cfg: StftConfig, samples_per_bucket: int = 16384):
        self.cfg = cfg
        self.step = samples_per_bucket

    def bucket(self, nsamps: int) -> int:
        b = -(-nsamps // self.step) * self.step
        # keep hop alignment so padded frames are complete
        hop = self.cfg.frame_hop
        return -(-b // hop) * hop


class BatchEnhancer:
    """Mask-based beamforming over batches of utterances.

    Feed (key, wav (N, S), mask (T, F)) triples; batches of equal bucket
    shape run through one ``enhance_batch`` call.  Runs on ``cuda``
    unless ``device="cpu"`` (``RuntimeError`` at construction when no
    card is present and no device was asked for).
    """

    def __init__(self,
                 cfg: StftConfig,
                 beamformer: str = "mvdr",
                 batch_size: int = 8,
                 mesh=None,
                 ban: bool = False,
                 samples_per_bucket: int = 16384,
                 chunk_size: int = -1,
                 alpha: float = 0.8,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh data parallelism arrives with ROADMAP queue 1 item 12")
        self.cfg = cfg
        self.beamformer = beamformer
        self.batch_size = batch_size
        self.ban = ban
        self.chunk_size = chunk_size
        self.alpha = alpha
        self.device = resolve_device(device)
        self.bucketer = LengthBucketer(cfg, samples_per_bucket)
        self._pending = defaultdict(list)

    def add(self, key, wav: np.ndarray, mask: np.ndarray):
        """Queue one utterance; returns flushed results (possibly [])."""
        n_ch, nsamps = wav.shape
        bucket = self.bucketer.bucket(nsamps)
        self._pending[(n_ch, bucket)].append((key, wav, mask))
        if len(self._pending[(n_ch, bucket)]) >= self.batch_size:
            return self._flush_bucket((n_ch, bucket))
        return []

    def flush(self):
        """Flush all remaining partial batches."""
        out = []
        for shape in list(self._pending):
            out.extend(self._flush_bucket(shape))
        return out

    def _flush_bucket(self, shape):
        items = self._pending.pop(shape, [])
        if not items:
            return []
        n_ch, bucket = shape
        t_pad = num_frames(bucket, self.cfg)
        f_bins = self.cfg.num_bins
        # int16 wavs stay int16 (the fused kernels convert on the card)
        wav_dt = (np.int16 if all(w.dtype == np.int16 for _, w, _ in items)
                  else np.float32)
        wavs = np.zeros((len(items), n_ch, bucket), dtype=wav_dt)
        masks = np.zeros((len(items), t_pad, f_bins), dtype=np.float32)
        lengths = []
        for i, (key, wav, mask) in enumerate(items):
            s = wav.shape[-1]
            if wav_dt == np.float32 and wav.dtype == np.int16:
                # mixed-dtype bucket: the batch went float32, so int16
                # items are rescaled here
                wavs[i, :, :s] = wav.astype(np.float32) / 32768.0
            else:
                wavs[i, :, :s] = wav
            t = min(mask.shape[0], t_pad)
            masks[i, :t, :] = mask[:t]
            lengths.append((key, s))
        logger.debug("bucket %s: %d utterances", shape, len(items))
        out = enhance_batch(torch.from_numpy(wavs).to(self.device),
                            torch.from_numpy(masks).to(self.device),
                            self.cfg, beamformer=self.beamformer,
                            ban=self.ban, nsamps=bucket,
                            chunk_size=self.chunk_size, alpha=self.alpha)
        out = out.cpu().numpy()
        return [(key, out[i, :s]) for i, (key, s) in enumerate(lengths)]
