"""The JAX package's parameters, as numpy arrays, to the port's and back.

* `unet_state_dict`: the Flax UNet parameter tree, flattened by key path
  ("params/ConvBlock_0/Conv_0/kernel", as tools/export_unet_npz.py writes
  it), into a `state_dict` of models/unet.UNet.  Conv kernels go from
  Flax's HWIO to torch's OIHW; GroupNorm scale/bias become weight/bias.
  The depth is the tree's own.
* `ct_unet_state_dict`: the same for the CT 3D UNet's tree
  ("params/ConvBlock3D_0/Conv_0/kernel", ...) into a `state_dict` of
  models/ct_unet.CTUNet; kernels go from DHWIO to OIDHW.
* `unet_flat_params`, `ct_unet_flat_params`: the inverses, a
  `state_dict` back into the flat Flax tree (float32 numpy), the layout
  of the npz checkpoints.
* `adamw_state`: optax's AdamW state (count, mu, nu) into the state of a
  `torch.optim.AdamW` over a model's parameters.
* `forest_tensors`: the forest npz (shoulder_tpu_torch/models/params/
  rfc_bg3.npz, the port's copy of the JAX package's) into the tensors of
  models/forest.ForestParams.
"""

from __future__ import annotations

import numpy as np
import torch


def n_levels(flat: dict, block: str) -> int:
    """Pooling levels of the UNet whose flat Flax tree is `flat`: it has
    2 * levels + 1 conv blocks named `block`_i."""
    blocks = {k.split("/")[1] for k in flat
              if k.split("/")[1].startswith(block + "_")}
    if not blocks or len(blocks) % 2 == 0:
        raise KeyError(f"{len(blocks)} {block} modules: not a UNet tree")
    return (len(blocks) - 1) // 2


# Flax names submodules by creation order: the encoder blocks, the
# bottleneck, then per decoder level one upsampling Conv and one block
def _module_map(block: str, levels: int):
    out = {}
    for i in range(levels):
        out[f"{block}_{i}"] = f"down.{i}"
        out[f"{block}_{levels + 1 + i}"] = f"up_blocks.{i}"
        out[f"Conv_{i}"] = f"up_convs.{i}"
    out[f"{block}_{levels}"] = "mid"
    out[f"Conv_{levels}"] = "head"
    return out


_BLOCK_PARTS = {"Conv_0": "conv0", "Conv_1": "conv1",
                "GroupNorm_0": "norm0", "GroupNorm_1": "norm1"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _torch_name(key: str, modules: dict) -> str:
    """"params/<module>/[<part>/]<leaf>" -> the state_dict's name."""
    parts = key.split("/")
    if parts[0] != "params":
        raise KeyError(f"unexpected parameter {key}")
    name = modules[parts[1]]
    if len(parts) == 4:
        name += "." + _BLOCK_PARTS[parts[2]]
    return f"{name}.{_LEAVES[parts[-1]]}"


def _state_dict(flat: dict, block: str) -> dict:
    modules = _module_map(block, n_levels(flat, block))
    state = {}
    for key, arr in flat.items():
        arr = np.asarray(arr, np.float32)
        if key.endswith("/kernel"):   # (*spatial, I, O) -> (O, I, *spatial)
            nd = arr.ndim
            arr = arr.transpose(nd - 1, nd - 2, *range(nd - 2))
        state[_torch_name(key, modules)] = torch.tensor(arr)  # a copy
    return state


def _flat_params(state: dict, block: str) -> dict:
    levels = 1 + max(int(k.split(".")[1]) for k in state
                     if k.startswith("down."))
    modules = {v: k for k, v in _module_map(block, levels).items()}
    parts = {v: k for k, v in _BLOCK_PARTS.items()}
    flat = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        is_norm = path[-1].startswith("norm")
        if path[-1] in parts:
            key = f"{modules['.'.join(path[:-1])]}/{parts[path[-1]]}"
        else:
            key = modules[".".join(path)]
        if leaf == "weight" and not is_norm:
            nd = arr.ndim             # (O, I, *spatial) -> (*spatial, I, O)
            arr = arr.transpose(*range(2, nd), 1, 0)
            leaf = "kernel"
        elif leaf == "weight":
            leaf = "scale"
        flat[f"params/{key}/{leaf}"] = np.ascontiguousarray(arr)
    return flat


def unet_state_dict(flat: dict) -> dict:
    """{"params/<module>/[<part>/]<leaf>": array} -> UNet state_dict."""
    return _state_dict(flat, "ConvBlock")


def ct_unet_state_dict(flat: dict) -> dict:
    """{"params/<module>/[<part>/]<leaf>": array} -> CTUNet state_dict."""
    return _state_dict(flat, "ConvBlock3D")


def unet_flat_params(state: dict) -> dict:
    """UNet state_dict -> {"params/<module>/[<part>/]<leaf>": float32
    array}, kernels back in HWIO."""
    return _flat_params(state, "ConvBlock")


def ct_unet_flat_params(state: dict) -> dict:
    """CTUNet state_dict -> the flat Flax tree, kernels back in DHWIO."""
    return _flat_params(state, "ConvBlock3D")


def adamw_state(model, optimizer, count: int, mu: dict, nu: dict) -> None:
    """Load optax's AdamW state into `optimizer`, a torch.optim.AdamW
    over `model`'s parameters: `count` steps taken, first and second
    moments `mu` and `nu` as flat Flax trees (the layout of the
    parameters).  optax's `count` is torch's `step`, `mu` its `exp_avg`,
    `nu` its `exp_avg_sq`."""
    block = "ConvBlock3D" if any("ConvBlock3D_" in k for k in mu) else "ConvBlock"
    moments = [_state_dict(tree, block) for tree in (mu, nu)]
    names = {id(p): name for name, p in model.named_parameters()}
    state, index = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            state[index] = {"step": torch.tensor(float(count)),
                            "exp_avg": moments[0][name],
                            "exp_avg_sq": moments[1][name]}
            index += 1
    optimizer.load_state_dict({"state": state,
                               "param_groups":
                                   optimizer.state_dict()["param_groups"]})


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
