"""Single-channel noise suppression: the OM-LSA gain with MCRA / iMCRA.

The port's counterpart of ``setk_tpu/enhance/ns.py`` (Cohen 2001 / Cohen
2003, equation by equation), with the same configurations, names and
signatures.  Each estimator's frame recursion runs in one launch of the
OM-LSA kernel (``ops/cuda/omlsa.py``, ``csrc/omlsa.cu``) on a CUDA
tensor, and as its plain version (a per-frame PyTorch loop in the JAX
module's order of operations) on a CPU tensor.
"""

from dataclasses import dataclass

import torch

from setk_tpu_torch.ops.cuda.omlsa import exp1
from setk_tpu_torch.ops.cuda.omlsa import omlsa as omlsa_kernel

__all__ = ["MCRAConfig", "IMCRAConfig", "mcra_gain", "imcra_gain", "omlsa",
           "exp1"]


@dataclass(frozen=True)
class MCRAConfig:
    alpha: float = 0.92
    delta: float = 5.0
    beta: float = 0.7
    alpha_s: float = 0.9
    alpha_d: float = 0.85
    alpha_p: float = 0.2
    gmin_db: float = -10.0
    xi_min_db: float = -18.0
    w_mcra: int = 1
    w_local: int = 1
    w_global: int = 15
    h_mcra: str = "hann"
    h_local: str = "hann"
    h_global: str = "hann"
    q_max: float = 0.95
    zeta_min_db: float = -10.0
    zeta_max_db: float = -5.0
    zeta_p_max_db: float = 10.0
    zeta_p_min_db: float = 0.0
    L: int = 125
    M: int = 128


@dataclass(frozen=True)
class IMCRAConfig:
    alpha: float = 0.92
    alpha_s: float = 0.9
    alpha_d: float = 0.85
    b_min: float = 1.66
    gamma0: float = 4.6
    gamma1: float = 3.0
    zeta0: float = 1.67
    xi_min_db: float = -18.0
    gmin_db: float = -10.0
    w_mcra: int = 1
    h_mcra: str = "hann"
    beta: float = 1.47
    V: int = 15
    U: int = 8


def _power(stft) -> torch.Tensor:
    """|X|^2 of a (T, F) complex STFT as a (1, T, F) f32 row."""
    stft = torch.as_tensor(stft)
    return (stft.abs()**2).to(torch.float32)[None].contiguous()


def mcra_gain(stft, cfg: MCRAConfig = MCRAConfig(),
              eps: float = 1e-7) -> torch.Tensor:
    """OM-LSA gain with the MCRA noise estimator: (T, F) complex ->
    (T, F) f32, on the tensor's device."""
    return omlsa_kernel(_power(stft), "mcra", cfg, eps)[0]


def imcra_gain(stft, cfg: IMCRAConfig = IMCRAConfig(),
               eps: float = 1e-7) -> torch.Tensor:
    """OM-LSA gain with the iMCRA noise estimator: (T, F) complex ->
    (T, F) f32, on the tensor's device."""
    return omlsa_kernel(_power(stft), "imcra", cfg, eps)[0]


def omlsa(stft, estimator: str = "imcra", **kwargs) -> torch.Tensor:
    """OM-LSA gain with the chosen noise estimator ('mcra'/'imcra')."""
    if estimator == "mcra":
        cfg = kwargs.pop("cfg", MCRAConfig(**kwargs))
        return mcra_gain(stft, cfg)
    if estimator == "imcra":
        cfg = kwargs.pop("cfg", IMCRAConfig(**kwargs))
        return imcra_gain(stft, cfg)
    raise ValueError(f"Unknown noise estimator: {estimator}")
