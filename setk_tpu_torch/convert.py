"""State carried across from the JAX package.

The MVDR main path has no learned weights: its state is the STFT
configuration and the window derived from it.  A configuration moves
as its plain fields, so this module needs nothing of the JAX package:

    stft_config_from_fields(**dataclasses.asdict(jax_cfg))

The converter for the mask-net parameters (flax pytree -> torch state
dict) comes with the neural mask estimators, ROADMAP queue 1 item 8.
"""

from setk_tpu_torch.dsp.stft import StftConfig

__all__ = ["stft_config_from_fields"]


def stft_config_from_fields(frame_len: int = 512, frame_hop: int = 256,
                            window: str = "hann", center: bool = True,
                            round_power_of_two: bool = True) -> StftConfig:
    """The port's StftConfig from a JAX StftConfig's dataclass fields."""
    return StftConfig(frame_len=int(frame_len), frame_hop=int(frame_hop),
                      window=str(window), center=bool(center),
                      round_power_of_two=bool(round_power_of_two))
