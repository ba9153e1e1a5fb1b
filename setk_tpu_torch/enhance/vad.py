"""Energy-proportion VAD masks for the per-utterance beamformer CLI.

The port's own copy of ``vad_masks`` and ``apply_vad_filter``
(setk_tpu/enhance/vad.py:260-283): the T-F bins whose magnitude lies
below the level that keeps ``proportion`` of the spectrogram's energy
are silence, and the target (and interference) masks are floored there.
Runs on the tensor's own device; numpy input is taken as a CPU tensor.
"""

import numpy as np
import torch

__all__ = ["vad_masks", "apply_vad_filter"]


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


def vad_masks(spectrogram, proportion: float):
    """spectrogram (F, T) complex -> (silence (T, F) bool, count).

    The threshold is the magnitude at which the cumulative sum of the
    sorted magnitudes passes (1 - proportion) of their total (sort,
    cumsum and a right-side search, as the JAX package vectorizes the
    reference's loop); bins below it are silence.  ``count`` is the
    search's index, the number of bins filtered.
    """
    energy = _tensor(spectrogram).abs()
    flat = torch.sort(energy.reshape(-1)).values
    csum = torch.cumsum(flat, dim=0)
    filter_energy = csum[-1] * (1.0 - proportion)
    index = torch.searchsorted(csum, filter_energy.reshape(1),
                               right=True)[0]
    threshold = flat[torch.clamp(index, max=flat.shape[0] - 1)]
    return (energy < threshold).T, index


def apply_vad_filter(mask, silence, floor: float = 1.0e-4):
    """Floor the T-F mask on the silence bins."""
    mask = _tensor(mask)
    return torch.where(_tensor(silence), torch.as_tensor(
        floor, dtype=mask.dtype, device=mask.device), mask)
