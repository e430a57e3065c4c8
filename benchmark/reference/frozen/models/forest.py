"""Vectorized random-forest inference (PyTorch, fixed depth).

Port of shoulder_tpu/models/forest.py.  The forest is the port's own
copy of the JAX package's parameter file,
shoulder_tpu_torch/models/params/rfc_bg3.npz (the same arrays as
shoulder_tpu/models/params/rfc_bg3.npz).  Evaluation
walks all trees for all samples in lockstep; each round advances `levels`
tree levels off one row gather of a per-node subtree table.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.frozen.models import convert



@dataclasses.dataclass
class ForestParams:
    feature: torch.Tensor       # (T, M) int64
    value: torch.Tensor         # (T, M) f32 thresholds
    true_child: torch.Tensor    # (T, M) int64 (self at leaves)
    false_child: torch.Tensor   # (T, M) int64
    leaf_weights: torch.Tensor  # (T, M, C) f32
    max_depth: int
    binary_complement: bool = False  # class-0 prob = 1 - class-1 sum


def load_params(device, npz_path) -> ForestParams:
    """The forest on `device`, read once per (device, file) per process;
    callers share the tensors and must not write to them."""
    return _load_params(str(torch.device(device)), str(npz_path))


@functools.lru_cache(maxsize=None)
def _load_params(device: str, npz_path: str) -> ForestParams:
    with np.load(npz_path) as z:
        return ForestParams(**convert.forest_tensors(
            {k: z[k] for k in z.files}, device))


def _subtree_table(params: ForestParams, levels: int):
    """(T, M, W) row per node holding its depth-`levels` subtree: per level
    l a block of 2^l features then 2^l thresholds (BFS order: position p
    has children 2p (true) and 2p+1 (false)), then the 2^levels
    descendant ids.  The small-int fields are exact as float32 values.
    Leaves self-loop, so running past a leaf keeps resolving to it."""
    n_trees, n_nodes = params.feature.shape
    feat = params.feature.to(torch.float32)
    thr = params.value
    ids = torch.arange(n_nodes, device=feat.device).view(1, n_nodes, 1)
    ids = ids.expand(n_trees, n_nodes, 1)
    blocks = []
    for _ in range(levels):
        w = ids.shape[2]
        flat = ids.reshape(n_trees, n_nodes * w)
        blocks += [feat.gather(1, flat).view(n_trees, n_nodes, w),
                   thr.gather(1, flat).view(n_trees, n_nodes, w)]
        tc = params.true_child.gather(1, flat).view(n_trees, n_nodes, w)
        fc = params.false_child.gather(1, flat).view(n_trees, n_nodes, w)
        ids = torch.stack([tc, fc], dim=-1).reshape(n_trees, n_nodes, 2 * w)
    blocks.append(ids.to(torch.float32))
    return torch.cat(blocks, dim=-1)


def predict_proba(params: ForestParams, x, levels: int = 3):
    """Class probabilities for samples x (R, n_features) -> (R, C).

    ONNX TreeEnsembleClassifier semantics with BRANCH_LEQ nodes: go to
    the true child when x[feature] <= value.
    """
    n_rows = x.shape[0]
    n_trees = params.feature.shape[0]
    packed = _subtree_table(params, levels)            # (T, M, W)
    width = packed.shape[2]
    rounds = -(-params.max_depth // levels)
    t_idx = torch.arange(n_trees, device=x.device)
    idx = torch.zeros((n_rows, n_trees), dtype=torch.int64, device=x.device)
    for _ in range(rounds):
        g = packed[t_idx[None, :], idx]                # (R, T, W)
        pos = torch.zeros_like(idx)
        off = 0
        for lvl in range(levels):
            w = 1 << lvl
            f_sel = g[..., off:off + w].gather(2, pos[..., None])[..., 0]
            t_sel = g[..., off + w:off + 2 * w].gather(2, pos[..., None])[..., 0]
            off += 2 * w
            xv = x.gather(1, f_sel.to(torch.int64))
            pos = 2 * pos + torch.where(xv <= t_sel, 0, 1)
        ids = g[..., off:width].gather(2, pos[..., None])[..., 0]
        idx = ids.to(torch.int64)
    lw = params.leaf_weights[t_idx[None, :], idx]      # (R, T, C)
    proba = lw.sum(dim=1)
    if params.binary_complement:
        proba = torch.cat([1.0 - proba[:, 1:2], proba[:, 1:]], dim=1)
    return proba
