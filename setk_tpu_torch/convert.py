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

The neural mask estimators carry trained weights: the flax parameter
tree (nested dicts of numpy arrays, what ``flax.serialization`` writes to
``final.msgpack`` under "params") maps name by name to the port's
``MaskNet`` state dict, whose submodules carry flax's automatic names.
``mask_net_params_from_numpy`` and ``mask_net_params_to_numpy`` carry it
across in both directions:

  Dense ``kernel`` (in, out)         <-> Linear ``weight`` (out, in)
  Conv ``kernel`` (kh, kw, in, out)  <-> ``weight`` (out, in, kh, kw)
  LayerNorm ``scale`` / ``bias``     <-> ``weight`` / ``bias``
  FastLSTM ``wh_f`` / ``wh_b``       <-> the same (H, 4H); ``wx_f`` /
                                         ``wx_b`` are Dense
"""

import numpy as np
import torch

from setk_tpu_torch.dsp.stft import StftConfig

__all__ = ["stft_config_from_fields", "em_state_from_numpy",
           "em_state_to_numpy", "mask_net_params_from_numpy",
           "mask_net_params_to_numpy"]

_EM_KEYS = ("phi", "covar", "alpha")
_LSTM_ORDER = ("wx_f", "wh_f", "wx_b", "wh_b")


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


def mask_net_params_from_numpy(params) -> dict:
    """A flax MaskNet parameter tree (nested dicts of numpy arrays, the
    "params" entry of a checkpoint) -> the port's ``MaskNet`` state dict
    (float32 CPU tensors; ``load_state_dict`` checks every name)."""
    state = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + [name])
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":        # Conv (kh, kw, in, out), Dense
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight" if name in ("kernel", "scale") else name
            state[".".join(prefix + [leaf])] = torch.tensor(arr)

    walk(params, [])
    return state


def mask_net_params_to_numpy(state_dict) -> dict:
    """The port's ``MaskNet`` state dict -> the flax parameter tree, arrays
    float32, in the order flax creates the parameters (the state dict's,
    but a FastLSTM's wx_f, wh_f, wx_b, wh_b), so ``save_checkpoint``
    writes what flax writes for the same values."""
    tree = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().cpu().float().numpy()
        if leaf.startswith("wh_"):
            name = leaf
        elif path[-1].startswith("LayerNorm"):
            name = "scale" if leaf == "weight" else "bias"
        else:
            name = "kernel" if leaf == "weight" else "bias"
            if name == "kernel":
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    for node in tree.values():
        if "wh_f" in node:
            for name in [n for n in _LSTM_ORDER if n in node]:
                node[name] = node.pop(name)
    return tree
