"""Marching tetrahedra over one volume (ops/marching_tets.py): the
volume read once (float32) and the triangles it gives written once
(9 float32 each); no operation count (bytes bound it)."""

HOOKS = (("ops.marching_tets", "marching_tets"),)
PRECISION = "fp32"
RANGES = ("marching_tets",)
KERNELS = ()


def work(fn, args, kwargs, result):
    volume = args[0]
    return volume.numel() * 4 + int(result.count) * 36, 0
