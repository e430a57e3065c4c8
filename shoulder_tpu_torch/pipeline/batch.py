"""Bone batching and device placement (PyTorch).

Port of the batch entry points of shoulder_tpu/pipeline/batch.py: build
BoneTensors from ingested BoneSpecs on an explicit device, stack them
into a batch, and run the landmark pipeline over the batch.  The batch
runs as one program, as JAX's vmap of compute_landmarks does: every stage
works on the leading bone dimension (pipeline.landmarks.landmarks_batch),
and each of the three slice stacks is one slice-stack kernel launch over
all the batch's planes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from shoulder_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from shoulder_tpu_torch.io.ingest import BoneSpec
from shoulder_tpu_torch.models import forest
from shoulder_tpu_torch.models import unet as unet_mod
from shoulder_tpu_torch.pipeline.landmarks import (
    BoneTensors,
    Landmarks,
    landmarks_batch,
)
from shoulder_tpu_torch.utils import trace


def _host_arrays(spec: BoneSpec) -> list[np.ndarray]:
    if spec.face_orig is None:
        raise ValueError(f"{spec.name}: faces must be presorted at ingest")
    return [
        np.asarray(spec.vertices, np.float32),
        np.asarray(spec.faces, np.int32),
        np.asarray(spec.neighbors, np.int32),
        np.asarray(spec.obb_transform, np.float32),
        np.float32(spec.z_bounds[0]),
        np.float32(spec.z_bounds[1]),
        np.float32(spec.z_length),
        np.float32(spec.cutoff_pcts[0]),
        np.float32(spec.cutoff_pcts[1]),
        np.asarray(spec.face_orig, np.int32),
    ]


def bone_tensors(spec: BoneSpec, device) -> BoneTensors:
    """Per-bone tensors on `device`."""
    return BoneTensors(*(torch.as_tensor(a, device=device)
                         for a in _host_arrays(spec)))


@trace.spanned("batch.stack")
def stack_bones(specs: Sequence[BoneSpec], device) -> BoneTensors:
    """Stack BoneSpecs into a leading batch dimension on `device`: one
    host-side stack and one copy per field."""
    return to_device(stack_host(specs), device)


def stack_host(specs: Sequence[BoneSpec], pin: bool = False) -> BoneTensors:
    """BoneSpecs stacked into host tensors with a leading batch dimension,
    in page-locked memory when `pin` (so a later copy can be
    asynchronous).  Host work only: no stream, no kernel."""
    fields = (torch.from_numpy(np.stack(f))
              for f in zip(*(_host_arrays(s) for s in specs)))
    return BoneTensors(*(t.pin_memory() if pin else t for t in fields))


def to_device(host: BoneTensors, device) -> BoneTensors:
    """Copy host bone tensors to `device` on the current stream; from
    pinned memory the copies are asynchronous, so the caller keeps `host`
    alive until they have run."""
    return BoneTensors(*(t.to(device, non_blocking=True) for t in host))


def compute_landmarks_batch(
    bones: BoneTensors,
    rf: forest.ForestParams | None = None,
    proximal: bool = False,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    chunk: int = 150,
    seg_model=None,
) -> Landmarks:
    """Landmarks of a stacked bone batch; every field gets a leading batch
    dimension.  One call of the batched pipeline for the whole batch: no
    loop over bones.  The forest and the UNet are loaded once per call
    when not given."""
    device = bones.verts.device
    if rf is None:
        rf = forest.load_params(device)
    if cfg.segmenter == "unet" and seg_model is None:
        seg_model = unet_mod.load_model(device)
    return landmarks_batch(bones, rf, proximal=proximal, cfg=cfg,
                           chunk=chunk, seg_model=seg_model)


@trace.spanned("batch.readback")
def landmarks_to_numpy(lm: Landmarks) -> Landmarks:
    """Landmarks as numpy arrays: one device-to-host copy per field, made
    after the whole bone is computed."""
    return Landmarks(*(x.cpu().numpy() for x in lm))
