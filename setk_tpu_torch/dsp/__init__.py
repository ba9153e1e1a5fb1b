"""STFT and windows."""

from setk_tpu_torch.dsp.stft import (StftConfig, forward_stft, inverse_stft,
                                     num_frames)

__all__ = ["StftConfig", "forward_stft", "inverse_stft", "num_frames"]
