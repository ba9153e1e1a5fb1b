"""Oracle T-F masks (training targets), elementwise on any device.

Counterpart of ``setk_tpu/enhance/masks.py`` (the compress/uncompress
pairs :20-41 and ``compute_mask`` :46): irm/ibm/wiener/iam/psm/psa/crm with
sigmoid/tangent compression; inputs are complex STFTs of the target and
the mixture with any leading batch axes.
"""

import torch

from setk_tpu_torch.utils.common import EPSILON

__all__ = [
    "sigmoid_compress", "sigmoid_uncompress", "tangent_compress",
    "tangent_uncompress", "compute_mask", "MASK_TYPES"
]

MASK_TYPES = ("irm", "ibm", "wiener", "iam", "psm", "psa", "crm")


def sigmoid_compress(x, a: float = 1.0, b: float = 0.0):
    """Numerically-stable sigmoid compression for complex-mask parts."""
    e = torch.exp(-x.abs() * a + b)
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def sigmoid_uncompress(m, a: float = 1.0, b: float = 0.0):
    m = torch.clamp(m, min=EPSILON)
    x = torch.clamp(1.0 / m - 1.0, min=EPSILON)
    return (b - torch.log(x)) / a


def tangent_compress(x, k: float = 10.0, c: float = 0.1):
    """Scaled-tanh compression: K * tanh(C x / 2), stable for both signs."""
    e = torch.exp(-x.abs() * c)
    return torch.sign(x) * (k * (1.0 - e) / (1.0 + e))


def tangent_uncompress(m, k: float = 10.0, c: float = 0.1):
    x = (k - m) / torch.clamp(k + m, min=EPSILON)
    return -torch.log(torch.clamp(x, min=EPSILON)) / c


def compute_mask(tgt, mix, mask: str = "irm"):
    """Oracle mask from target & mixture STFTs (same shapes, complex).

    irm uses sqrt(|s|^2 + |n|^2) normalization (the reference's choice);
    crm returns compressed real/imag parts stacked on the last axis.
    """
    tgt_abs = tgt.abs()
    mix_abs = mix.abs()
    inf_abs = (mix - tgt).abs()
    if mask == "ibm":
        return (tgt_abs > inf_abs).float()
    if mask == "irm":
        return tgt_abs / torch.sqrt(tgt_abs**2 + inf_abs**2 + EPSILON)
    if mask == "wiener":
        return tgt_abs**2 / (tgt_abs**2 + inf_abs**2 + EPSILON)
    if mask == "iam":
        return tgt_abs / torch.clamp(mix_abs, min=EPSILON)
    if mask in ("psm", "psa"):
        cos = torch.cos(mix.angle() - tgt.angle())
        if mask == "psm":
            return tgt_abs * cos / torch.clamp(mix_abs, min=EPSILON)
        return tgt_abs * torch.clamp(cos, min=0.0)
    if mask == "crm":
        cpx = tgt / (mix + EPSILON)
        return torch.cat([tangent_compress(cpx.real),
                          tangent_compress(cpx.imag)], dim=-1)
    raise ValueError(f"Unknown mask type: {mask}")
