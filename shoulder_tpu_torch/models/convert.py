"""Turn the JAX package's parameters, as numpy arrays, into the port's.

* `unet_state_dict`: the Flax UNet parameter tree, flattened by key path
  ("params/ConvBlock_0/Conv_0/kernel", as tools/export_unet_npz.py writes
  it), into a `state_dict` of models/unet.UNet.  Conv kernels go from
  Flax's HWIO to torch's OIHW; GroupNorm scale/bias become weight/bias.
* `ct_unet_state_dict`: the same for the CT 3D UNet's tree
  ("params/ConvBlock3D_0/Conv_0/kernel", ...) into a `state_dict` of
  models/ct_unet.CTUNet; kernels go from DHWIO to OIDHW.
* `forest_tensors`: the forest npz (shoulder_tpu_torch/models/params/
  rfc_bg3.npz, the port's copy of the JAX package's) into the tensors of
  models/forest.ForestParams.
"""

from __future__ import annotations

import numpy as np
import torch


# Flax names submodules by creation order: the encoder blocks, the
# bottleneck, then per decoder level one upsampling Conv and one block
def _module_map(block: str, n_levels: int):
    out = {}
    for i in range(n_levels):
        out[f"{block}_{i}"] = f"down.{i}"
        out[f"{block}_{n_levels + 1 + i}"] = f"up_blocks.{i}"
        out[f"Conv_{i}"] = f"up_convs.{i}"
    out[f"{block}_{n_levels}"] = "mid"
    out[f"Conv_{n_levels}"] = "head"
    return out


_BLOCK_PARTS = {"Conv_0": "conv0", "Conv_1": "conv1",
                "GroupNorm_0": "norm0", "GroupNorm_1": "norm1"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _state_dict(flat: dict, block: str, n_levels: int) -> dict:
    modules = _module_map(block, n_levels)
    state = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] != "params":
            raise KeyError(f"unexpected parameter {key}")
        name = modules[parts[1]]
        if len(parts) == 4:
            name += "." + _BLOCK_PARTS[parts[2]]
        leaf = parts[-1]
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":          # (*spatial, I, O) -> (O, I, *spatial)
            nd = arr.ndim
            arr = arr.transpose(nd - 1, nd - 2, *range(nd - 2))
        state[f"{name}.{_LEAVES[leaf]}"] = torch.tensor(arr)  # a copy
    return state


def unet_state_dict(flat: dict) -> dict:
    """{"params/<module>/[<part>/]<leaf>": array} -> UNet state_dict."""
    return _state_dict(flat, "ConvBlock", 3)


def ct_unet_state_dict(flat: dict) -> dict:
    """{"params/<module>/[<part>/]<leaf>": array} -> CTUNet state_dict."""
    return _state_dict(flat, "ConvBlock3D", 2)


def forest_tensors(z: dict, device) -> dict:
    """Forest npz arrays -> keyword arguments of forest.ForestParams."""
    def t(name, dtype):
        return torch.as_tensor(np.asarray(z[name]), dtype=dtype, device=device)

    return dict(
        feature=t("feature", torch.int64),
        value=t("value", torch.float32),
        true_child=t("true_child", torch.int64),
        false_child=t("false_child", torch.int64),
        leaf_weights=t("leaf_weights", torch.float32),
        max_depth=int(z["max_depth"]),
        binary_complement=bool(z.get("binary_complement", False)),
    )
