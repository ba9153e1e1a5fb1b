"""State carried across from the JAX package.

The MVDR main path has no learned weights: its state is the STFT
configuration and the window derived from it.  A configuration moves
as its plain fields, so this module needs nothing of the JAX package:

    stft_config_from_fields(**dataclasses.asdict(jax_cfg))

The clustering EM has no learned weights either: its carried state is
the per-utterance EM state dict that ``--dump-model`` saves and
``--resume-model`` reads ({phi, covar, alpha} for CGMM, {covar, alpha}
for CACGMM).  ``em_state_from_numpy`` and ``em_state_to_numpy`` carry it
across in both directions, as numpy arrays of the JAX package's dtypes
(complex64 covariances, float32 phi and alpha).

WPE dereverberation and factored WPD have no trained parameters and no
resumable state: they carry nothing across, and the tests feed the same
numpy-made spectra to both packages.

The converter for the mask-net parameters (flax pytree -> torch state
dict) comes with the neural mask estimators, ROADMAP queue 1 item 8.
"""

import numpy as np
import torch

from setk_tpu_torch.dsp.stft import StftConfig

__all__ = ["stft_config_from_fields", "em_state_from_numpy",
           "em_state_to_numpy"]

_EM_KEYS = ("phi", "covar", "alpha")


def stft_config_from_fields(frame_len: int = 512, frame_hop: int = 256,
                            window: str = "hann", center: bool = True,
                            round_power_of_two: bool = True) -> StftConfig:
    """The port's StftConfig from a JAX StftConfig's dataclass fields."""
    return StftConfig(frame_len=int(frame_len), frame_hop=int(frame_hop),
                      window=str(window), center=bool(center),
                      round_power_of_two=bool(round_power_of_two))


def _em_dtype(key):
    if key not in _EM_KEYS:
        raise ValueError(f"unknown EM state entry {key!r}; expected "
                         f"{_EM_KEYS}")
    return np.complex64 if key == "covar" else np.float32


def em_state_from_numpy(state, device) -> dict:
    """An EM state dict of numpy arrays (the JAX CLI's ``--dump-model``
    .npz, or ``em_state_to_numpy``'s output) -> torch tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v).astype(_em_dtype(k), copy=False))).to(device)
        for k, v in state.items()}


def em_state_to_numpy(state) -> dict:
    """An EM state dict of torch tensors -> numpy arrays of the JAX
    package's dtypes, what ``np.savez`` writes for ``--dump-model``."""
    return {k: v.detach().cpu().numpy().astype(_em_dtype(k), copy=False)
            for k, v in state.items()}
