"""Throughput counters and profiler traces.

Counterpart of ``setk_tpu/utils/profiling.py``:

  * ``ThroughputMeter``: audio-seconds per wall second (and the RTF, its
    inverse) with periodic logging, used by the executors and CLIs;
  * ``trace``: ``torch.profiler.profile`` over a block (host and CUDA
    activity), exported as a Chrome trace into a directory, where the JAX
    package writes a ``jax.profiler`` trace;
  * ``annotate``: a named region on that timeline
    (``torch.profiler.record_function``).
"""

import contextlib
import time
from pathlib import Path

from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

__all__ = ["ThroughputMeter", "trace", "annotate"]


class ThroughputMeter:
    """Accumulate processed audio seconds against wall-clock time.

    ``update(audio_seconds)`` after each batch; ``rate()`` returns
    audio-seconds per wall second (higher is better), ``rtf()`` the
    real-time factor (processing seconds per audio second, lower is
    better).
    """

    def __init__(self, name: str = "pipeline", report_every: int = 0):
        self.name = name
        self.report_every = report_every
        self.audio_seconds = 0.0
        self.num_updates = 0
        self._start = time.perf_counter()

    def reset(self):
        self.audio_seconds = 0.0
        self.num_updates = 0
        self._start = time.perf_counter()

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self._start

    def update(self, audio_seconds: float):
        self.audio_seconds += float(audio_seconds)
        self.num_updates += 1
        if self.report_every and self.num_updates % self.report_every == 0:
            self.report()

    def rate(self) -> float:
        wall = self.wall_seconds
        return self.audio_seconds / wall if wall > 0 else 0.0

    def rtf(self) -> float:
        return self.wall_seconds / self.audio_seconds \
            if self.audio_seconds > 0 else float("inf")

    def report(self):
        logger.info(
            "%s: %.1f audio-s in %.2f s (%.1f audio-s/s, RTF %.2e)",
            self.name, self.audio_seconds, self.wall_seconds, self.rate(),
            self.rtf())


@contextlib.contextmanager
def trace(logdir):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when a
    card is present) and write ``logdir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto).  A falsy ``logdir`` profiles nothing."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    logger.info("torch profiler trace written to %s", out / "trace.json")


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the profiler timeline."""
    from torch.profiler import record_function
    with record_function(name):
        yield
