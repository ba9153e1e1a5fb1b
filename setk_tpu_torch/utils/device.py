"""Device resolution for the port's entry points.

Takes the place of ``setk_tpu/utils/hostdev.tpu_target``: the port
dispatches on the device a tensor lies on, not on a process-wide
default.  Entry points run on ``cuda`` unless the caller asks for the
CPU; with no card and no explicit ``device="cpu"`` they raise and never
carry on on the CPU.
"""

import torch

__all__ = ["resolve_device", "full_f32_matmuls"]


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` given: that device (a ``cuda`` request with no card
    raises).  Else a tensor ``like`` keeps its own device.  Else
    ``cuda``, which raises ``RuntimeError`` when no card is present.
    """
    if device is None and isinstance(like, torch.Tensor):
        return like.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "setk_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def full_f32_matmuls(device: torch.device) -> None:
    """Keep float32 products in full float32 on the card.

    PyTorch's cuDNN convolutions default to TF32 (about three decimal
    digits), the error class this toolkit measured costing parity in
    Gram products; the plain paths set both switches off before running
    on a CUDA device.
    """
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
