# ``wpe`` is the submodule (its entry point is ``wpe.wpe``): binding the
# function to that name here would hide the module of the same name
from setk_tpu_torch.enhance import wpe
from setk_tpu_torch.enhance.wpe import wpd

__all__ = ["wpe", "wpd"]
