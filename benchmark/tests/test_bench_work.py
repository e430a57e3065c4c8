"""The work model's counts from shapes and inputs, held to the counts the
repository recorded on the card (PERF.md's table of kernels, chip_smoke.py
phases 4, 5c and 9) and, for the UNets, to a count of every convolution
by forward hooks."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import ingest_worker
from benchmark.reference.frozen import config as fconfig
from benchmark.reference.frozen.models import ct_unet, unet
from benchmark.reference.frozen.ops import slicing
from benchmark.reference.frozen.pipeline import batch as B
from benchmark.reference.frozen.pipeline import landmarks as L
from benchmark.reference.frozen.utils import geometry as geom
from benchmark.work import _conv, _model, sphere
from benchmark.work import slice_stack as ss

torch.set_num_threads(4)


def _hooked_ops(model, x):
    total = 0

    def count(mod, _inputs, out):
        nonlocal total
        total += 2 * out.numel() * mod.in_channels * int(
            np.prod(mod.kernel_size))

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return total


@pytest.mark.parametrize("shape", [(1, 1, 40, 24), (3, 1, 16, 32)])
def test_unet2d_ops_equal_the_convolutions(shape):
    model = unet.UNet(compute_dtype=torch.float32)
    image = torch.zeros(shape[0], shape[2], shape[3])
    ops = _conv.unet_work(shape[2:], model.features, 2, batch=shape[0])[1]
    assert ops == _hooked_ops(model, torch.zeros(shape))
    assert _conv.unet_work((511, 512), unet.UNet().features, 2,
                           batch=8)[1] == 166_564_200_448
    del image


def test_unet3d_ops_equal_the_convolutions_and_the_record():
    model = ct_unet.CTUNet(compute_dtype=torch.float32)
    assert _conv.unet_work((8, 12, 16), model.features, 3)[1] == \
        _hooked_ops(model, torch.zeros(1, 1, 8, 12, 16))
    ops = _conv.unet_work((320, 144, 144), model.features, 3)[1]
    assert round(ops / 1e9, 2) == 175.28


def test_sphere_counts_equal_the_record():
    n_bytes, ops = sphere.sphere_work("score", 8, 262_144, n_hyp=130)
    assert round(ops / 1e9, 3) == 4.907
    n_bytes, ops = sphere.sphere_work("tukey", 8, 262_144)
    assert round(n_bytes / 1e6, 1) == 25.2
    assert _model.bound(n_bytes, ops)[1] == "bytes"


def test_slice_stacks_equal_the_record():
    """Phase 4's eight bones (chip_smoke.py) at DEFAULT_CONFIG: the three
    stacks' bytes of the batch, as PERF.md's table records them."""
    from benchmark.inputs.humerus import synthetic_humerus
    from benchmark.reference.frozen.io import stl

    cfg = fconfig.DEFAULT_CONFIG
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i in range(8):
            v, f = synthetic_humerus(side=("left", "right")[i % 2],
                                     rng_transform=np.random.default_rng(i))
            paths.append(str(Path(td) / f"bone{i}.stl"))
            stl.write_stl(paths[-1], v, f)
        specs = ingest_worker.pool_map(ingest_worker.load_bone,
                                       [(p, cfg) for p in paths])
    bones = B.stack_bones(specs, "cpu")
    verts_obb = geom.transform_pts(bones.verts, bones.obb_transform)
    sg = slicing.sorted_geom(verts_obb, bones.faces, bones.neighbors,
                             bones.face_orig)

    def stack(zs, sset):
        return slicing.slice_stack(sg, zs, sset.interp_num, sset.band,
                                   cfg.slice_compact_k)

    def work(zs, sset):
        band = min(sset.band, sg.z_key.shape[-1])
        return ss.stack_work(slicing, sg, zs, sset.interp_num, band,
                             min(cfg.slice_compact_k, band))[0]

    zs_full = geom.linspace(cfg.z_inset * bones.z_max,
                            cfg.z_inset * bones.z_min, cfg.full.zslice_num)
    full = stack(zs_full, cfg.full)
    neck_z = L._surgical_neck(full, bones, False, cfg, cfg.max_chain, sg)[0]
    zs_prox = geom.linspace(cfg.z_inset * bones.z_max, neck_z,
                            cfg.proximal.zslice_num)
    zs_dist = geom.linspace(cfg.z_inset * bones.z_min, 0.0,
                            cfg.distal.zslice_num)
    got = (work(zs_full, cfg.full), work(zs_prox, cfg.proximal),
           work(zs_dist, cfg.distal))
    assert got == (21_026_628, 24_504_436, 16_363_120)
