"""Mask-estimator training and checkpoint IO.

Counterpart of ``setk_tpu/models/trainer.py``: Adam over the quadratic
mask objective (``torch.optim.Adam`` with optax ``adam``'s defaults: betas
0.9, 0.999, eps 1e-8 outside the square root, the same update), and
checkpoints in the JAX package's format, a flax msgpack of {"params": the
flax parameter tree} plus a ``.json`` of the model's meta, written and
read without flax (``io.flax_msgpack``), so either package reads the
other's.  The init draws from a ``torch.Generator`` seeded with ``seed``
with flax's initializers' distributions; it cannot equal flax's
``PRNGKey`` draws, so parity runs from converted weights.
"""

import json
from pathlib import Path

import torch

from setk_tpu_torch.convert import (mask_net_params_from_numpy,
                                    mask_net_params_to_numpy)
from setk_tpu_torch.io import flax_msgpack
from setk_tpu_torch.models.mask_net import MaskNet, make_model, \
    quadratic_loss, refuse_on_card
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device
from setk_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

__all__ = ["MaskTrainer", "save_checkpoint", "load_checkpoint"]


def save_checkpoint(path, state_dict, meta: dict):
    """Write a MaskNet state dict as the JAX package's checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(flax_msgpack.dumps(
        {"params": mask_net_params_to_numpy(state_dict)}))
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))
    logger.info(f"Saved checkpoint to {path}")


def load_checkpoint(path, device=None):
    """(model with the checkpoint's weights on ``device``, the meta
    dict), from either package's checkpoint.  ``device`` defaults to
    ``cuda`` (``utils.device.resolve_device``); a blstm outside kernels
    20/21's gate refuses there before the weights are read."""
    path = Path(path)
    device = resolve_device(device)
    meta = json.loads(Path(str(path) + ".json").read_text())
    refuse_on_card(meta["arch"], meta["hidden"], device)
    model = make_model(arch=meta["arch"], num_bins=meta["num_bins"],
                       hidden=meta["hidden"], num_layers=meta["num_layers"])
    params = flax_msgpack.loads(path.read_bytes())["params"]
    model.load_state_dict(mask_net_params_from_numpy(params))
    return model.to(device), meta


class MaskTrainer:
    """Adam training of a MaskNet on (log-spec, target-mask) batches."""

    def __init__(self, model: MaskNet, lr: float = 1e-3, mesh=None,
                 seed: int = 0, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh data parallelism arrives with ROADMAP queue 1 item 12")
        self.device = resolve_device(device)
        refuse_on_card(model.arch, model.hidden, self.device)
        full_f32_matmuls(self.device)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.opt = torch.optim.Adam(model.parameters(), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def train_batch(self, feats, targets, frame_mask):
        """One step over (B, T, F) float32 arrays; returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        loss = quadratic_loss(self.model(self._tensor(feats)),
                              self._tensor(targets),
                              self._tensor(frame_mask))
        loss.backward()
        self.opt.step()
        return loss.item()

    def predict(self, feats):
        with torch.no_grad():
            return self.model(self._tensor(feats))
