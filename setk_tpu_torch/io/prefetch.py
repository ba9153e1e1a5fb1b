"""Background prefetching wav loader over the native threaded decoder.

The reference's throughput story is N independent run.pl processes each
reading wavs serially; here one process overlaps disk/decode with device
compute: a producer thread probes headers, packs a window of upcoming
utterances into one flat buffer, and decodes them with the native thread
pool (native/wav_io.cc) in a single call — so the accelerator never
waits on the loader.  Yields exactly what ``WaveReader`` iteration
yields ((key, (C, S) float32 or (S,) for mono)); entries the native path
cannot serve (pipes, wav-ark offsets) go through the Python decoder
inside the producer thread.  This is host I/O, not a device path; the
loader logs which decoder ran.  The port's copy of
setk_tpu/io/prefetch.py.
"""

import glob
import queue
import threading

import numpy as np

from setk_tpu_torch.io.readers import WaveReader
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

__all__ = ["PrefetchWaveLoader"]

_STOP = object()


class PrefetchWaveLoader:
    """Iterate (key, samples) with windowed, threaded decode-ahead."""

    def __init__(self, wav_scp, sr=16000, normalize=True, window=16,
                 depth=2, num_threads=None):
        self.reader = WaveReader(wav_scp, sr=sr, normalize=normalize,
                                 native=False)
        self.sr = sr
        self.normalize = normalize
        self.window = max(int(window), 1)
        self.depth = max(int(depth), 1)
        self.num_threads = num_threads

    def __len__(self):
        return len(self.reader)

    def keys(self):
        return self.reader.keys()

    # ------------------------------------------------------------------
    def _plan(self, keys):
        """Probe headers for a window of keys; build native decode jobs.

        Returns (jobs, layouts, fallbacks): jobs are per-file
        (path, offset, chan_stride) into one flat buffer; layouts map
        key -> (buffer offset, channels, frames); fallbacks are keys the
        native loader cannot serve.
        """
        from setk_tpu_torch.io.native_wav import wav_info_native
        jobs, layouts, fallbacks = [], {}, []
        cursor = 0
        for key in keys:
            fname = self.reader.index_dict[key].rstrip()
            if fname[-1] == "|" or ":" in fname:
                fallbacks.append(key)
                continue
            flist = sorted(glob.glob(fname)) if any(
                c in fname for c in "*?[") else [fname]
            if not flist:
                raise RuntimeError(f"Could not find file matching '{fname}'")
            infos = [wav_info_native(f) for f in flist]
            frames = infos[0][2]
            for ch, fsr, fr in infos:
                if fsr != self.sr:
                    raise RuntimeError(
                        f"Expect sr={self.sr} of {key}, get {fsr} instead")
                if fr != frames:
                    raise RuntimeError(
                        f"Channel length mismatch for {key}: {fr} vs {frames}")
            total_ch = sum(i[0] for i in infos)
            layouts[key] = (cursor, total_ch, frames)
            ch_off = 0
            for f, (ch, _, _) in zip(flist, infos):
                jobs.append((f, cursor + ch_off * frames, frames))
                ch_off += ch
            cursor += total_ch * frames
        return jobs, layouts, fallbacks, cursor

    def _produce(self, out_q, stop_evt):
        from setk_tpu_torch.io.native_wav import batch_read_into
        keys = self.reader.keys()
        python_decoded = 0
        try:
            for beg in range(0, len(keys), self.window):
                if stop_evt.is_set():
                    return
                chunk = keys[beg:beg + self.window]
                jobs, layouts, fallbacks, total = self._plan(chunk)
                buf = np.empty(total, dtype=np.float32)
                if jobs:
                    batch_read_into([j[0] for j in jobs], buf,
                                    [j[1] for j in jobs],
                                    chan_stride=[j[2] for j in jobs],
                                    normalize=self.normalize,
                                    num_threads=self.num_threads)
                for key in chunk:
                    if key in layouts:
                        off, ch, frames = layouts[key]
                        samps = buf[off:off + ch * frames].reshape(ch, frames)
                        if ch == 1:
                            samps = samps[0]
                    else:
                        samps = self.reader.read(key)
                        python_decoded += 1
                    out_q.put((key, samps))
            if python_decoded:
                logger.info("wav decode: %d of %d entries through the Python "
                            "decoder (pipes, wav-ark offsets)",
                            python_decoded, len(keys))
            out_q.put(_STOP)
        except BaseException as exc:  # surface in the consumer
            out_q.put(exc)

    def __iter__(self):
        from setk_tpu_torch.utils.native import native_available
        if not native_available():
            logger.info("wav decode: Python decoder (the native library "
                        "is not available)")
            yield from self.reader
            return
        logger.info("wav decode: native threaded decoder")
        out_q = queue.Queue(maxsize=self.depth * self.window)
        stop_evt = threading.Event()
        thr = threading.Thread(target=self._produce, args=(out_q, stop_evt),
                               daemon=True)
        thr.start()
        try:
            while True:
                item = out_q.get()
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop_evt.set()
            # unblock the producer if it is waiting on a full queue
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thr.join(timeout=5.0)
