"""Griffin-Lim phase reconstruction as a fixed-iteration loop.

The port's counterpart of ``setk_tpu/dsp/griffin_lim.py``: a random
initial phase, then ``epochs`` rounds of iSTFT -> STFT -> phase
projection over the port's ``dsp/stft`` (``torch.fft``), batched over
leading axes, on the magnitudes' device.  The initial phase comes from a
seeded CPU ``torch.Generator`` and then moves to the device, so a card
run and a CPU run start from the same phase; it is not the phase that
``jax.random.uniform`` draws from the same seed (the two generators
differ by design).
"""

import math

import torch

from setk_tpu_torch.dsp.stft import StftConfig, forward_stft, inverse_stft
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["griffin_lim"]


def _griffin_lim_from(mag: torch.Tensor, phase0: torch.Tensor,
                      cfg: StftConfig, epochs: int,
                      norm: float | None) -> torch.Tensor:
    """The loop from the initial phases ``phase0`` (uniform on [0, 1),
    the mag's shape): samples (..., S)."""
    phase = torch.exp(2j * math.pi * phase0)
    samps = inverse_stft(mag * phase, cfg)
    for _ in range(epochs):
        spec = forward_stft(samps, cfg)
        phase = spec / torch.clamp(spec.abs(), min=EPSILON)
        samps = inverse_stft(mag * phase, cfg)
    if norm is not None:
        peak = samps.abs().amax(dim=-1, keepdim=True)
        samps = samps * norm / (peak + EPSILON)
    return samps


def griffin_lim(mag,
                cfg: StftConfig,
                key: int | torch.Generator | None = None,
                epochs: int = 30,
                norm: float | None = None) -> torch.Tensor:
    """Reconstruct ``(..., S)`` samples from magnitudes ``(..., T, F)``,
    on the magnitudes' device.  ``key``: a CPU generator, or its seed
    (0 when None)."""
    mag = torch.as_tensor(mag, dtype=torch.float32)
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(0 if key is None else key)
    phase0 = torch.rand(mag.shape, generator=gen, dtype=torch.float32)
    return _griffin_lim_from(mag, phase0.to(mag.device), cfg, epochs, norm)
