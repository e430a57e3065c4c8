"""The plain reference over a run's inputs: the frozen copy of the port's
plain path (benchmark/reference/frozen) on the same device, in the
precision the configuration states (float32 with TF32 off, the UNets'
bfloat16 convolutions summed in float32 and rounded once), or, for a
control, a step below it (`CONTROLS`).

It reads only the raw inputs (STL files, volumes) and the shipped
weights the configuration names, and works out everything else again:
ingest (numpy), segmentation, surface, weld, stacks, landmarks.  With a
`work` sink it records, call by call, the work model's count of each
piece of work it does (benchmark/work)."""

from __future__ import annotations

import contextlib
import importlib

import torch

from benchmark.harness import spec as S
from benchmark.reference import ingest_worker
from benchmark.reference.frozen import config as fconfig
from benchmark.reference.frozen.models import ct_unet, forest, unet
from benchmark.reference.frozen.pipeline import batch as B
from benchmark.reference.frozen.pipeline import ct as fct


def frozen_config(conf: dict):
    return S.pipeline_config(conf, fconfig.DEFAULT_CONFIG)


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and convolutions in full float32, never TF32, as
    the configuration states."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def lower_precision():
    """The control's precision, the step below each one the configuration
    states: TF32 for the float32 matmuls and convolutions, and the UNets'
    bfloat16 convolutions as cuDNN computes them without the port's one
    rounding: the sum rounded to bfloat16, then the bias added in
    bfloat16, a second rounding."""

    def forward(self, x):
        dt = self.compute_dtype
        out = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return out + self.bias.to(dt).view(1, -1, *([1] * (out.dim() - 2)))

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, unet.CastConv.forward)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    unet.CastConv.forward = forward
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, unet.CastConv.forward) = saved


# the controls, each a step below the precisions the configuration
# states: "unet", TF32 for its float32 matmuls and convolutions and the
# UNets' convolutions without the one rounding; "all" (the control of
# `correct`), those and the bones' vertex coordinates held in bfloat16,
# the format below the float32 of the geometry's elementwise arithmetic
CONTROLS = ("unet", "all")


def precision(control):
    if control and control not in CONTROLS:
        raise ValueError(f"control {control!r}: one of {CONTROLS}")
    return lower_precision() if control else full_float32()


def bf16_vertices(bones):
    """Vertex coordinates rounded to bfloat16."""
    return bones._replace(verts=bones.verts.to(torch.bfloat16)
                          .to(torch.float32))


class WorkSink:
    """(piece, bytes, operations) of every call the work model counts,
    under the key set by `at`."""

    def __init__(self):
        self.calls: dict = {}
        self.key = None

    def at(self, key):
        self.key = key
        self.calls.setdefault(key, [])

    def add(self, piece, n_bytes, n_ops):
        self.calls[self.key].append((piece, n_bytes, n_ops))


@contextlib.contextmanager
def recording(sink: WorkSink | None):
    if sink is None:
        yield
        return
    saved = []
    for piece in S.work_pieces():
        mod = S.work_piece(piece)
        for modname, fn in mod.HOOKS:
            target = importlib.import_module(
                f"benchmark.reference.frozen.{modname}")
            orig = getattr(target, fn)

            def wrapped(*args, _orig=orig, _mod=mod, _piece=piece, _fn=fn,
                        **kwargs):
                result = _orig(*args, **kwargs)
                sink.add(_piece, *_mod.work(_fn, args, kwargs, result))
                return result

            saved.append((target, fn, orig))
            setattr(target, fn, wrapped)
    try:
        yield
    finally:
        for target, fn, orig in reversed(saved):
            setattr(target, fn, orig)


def ingest_files(paths, conf):
    cfg = frozen_config(conf)
    return ingest_worker.pool_map(ingest_worker.load_bone,
                                  [(str(p), cfg) for p in paths])


def landmarks(spec_batches, conf, device, control=None, sink=None,
              keys=None):
    """[numpy Landmarks] of each batch of BoneSpecs; with `control` (one
    of CONTROLS), a step below the configuration's precision."""
    cfg = frozen_config(conf)
    rf = forest.load_params(device, S.weight(conf, "forest"))
    seg = (unet.load_model(device, S.weight(conf, "unet"))
           if cfg.segmenter == "unet" else None)
    out = []
    with precision(control), torch.no_grad():
        for i, specs in enumerate(spec_batches):
            if sink is not None:
                sink.at(keys[i] if keys else i)
            bones = B.stack_bones(specs, device)
            if control == "all":
                bones = bf16_vertices(bones)
            with recording(sink):
                lm = B.compute_landmarks_batch(bones, rf, cfg=cfg,
                                               seg_model=seg)
            out.append(B.landmarks_to_numpy(lm))
            del lm
    return out


def ct_specs(volumes, conf, device, sink=None, keys=None, control=None):
    """BoneSpecs of CT volumes [(volume, origin, spacing)]: the 3D UNet
    and marching tets on `device` (with `control`, a step below the
    configuration's precision), the weld and ingest by numpy in worker
    processes."""
    cfg = frozen_config(conf)
    model = ct_unet.load_model(device, S.weight(conf, "ct_unet"))
    max_tris = int(conf["inputs"]["max_tris"])
    soups = []
    with precision(control), torch.no_grad():
        for i, (vol, origin, spacing) in enumerate(volumes):
            if sink is not None:
                sink.at(keys[i] if keys else i)
            with recording(sink):
                seg, iso = fct.segment_volume(vol, model, device)
                soups.append(fct.surface(seg, origin, spacing, iso, max_tris))
            del seg
    return ingest_worker.pool_map(ingest_worker.weld_bone,
                                  [(t, cfg) for t in soups])
