"""The surgical neck's raw loop (ops/slicing.py slice_raw_banded), one
plane a bone, counted from its inputs (chip_smoke.py's raw_work): each
bone's z_mm window, each fvt/ids row of a kept crossed face, the z_key
entries a binary search reads and the cummax_z_max entry of the overflow
test (at lo - 1, lo > 0) read once, z once; points, n, area, centroid
and overflow written once.  Operations: about 40 float32 per kept
face."""

from __future__ import annotations

import torch

from benchmark.work.slice_stack import searched_keys

HOOKS = (("ops.slicing", "slice_raw_banded"),)
PRECISION = "fp32"
RANGES = ()
KERNELS = ("slice_raw_kernel",)


def raw_work(slicing, sg, z, band, k, max_chain):
    n_bytes = n_ops = 0
    for b in range(z.shape[0]):
        one = slicing.SortedGeom(*(x[b] for x in sg))
        zb = z[b:b + 1]
        lo, _starts, _over = slicing._window_starts(one, zb, band)
        zmm = one.z_mm[lo[:, None] + torch.arange(band, device=z.device)]
        kept = min(int(((zmm[..., 1] >= zb[:, None])
                        & (zmm[..., 0] < zb[:, None])).sum()), k)
        n_bytes += (band * 8 + kept * (9 * 4 + 4 * 4)
                    + searched_keys(one.z_key, zb) * 4
                    + (4 if int(lo[0]) > 0 else 0) + 4
                    + max_chain * 8 + 8 + 4 + 8 + 1)
        n_ops += 40 * kept
    return n_bytes, n_ops


def work(fn, args, kwargs, result):
    from benchmark.reference.frozen.ops import slicing

    names = ("sg", "z", "band", "max_chain", "select", "k")
    a = dict(zip(names, args))
    a.update(kwargs)
    a.setdefault("max_chain", 2048)
    a.setdefault("k", 512)
    band = min(a["band"], a["sg"].z_key.shape[-1])
    return raw_work(slicing, a["sg"], a["z"], band, min(a["k"], band),
                    a["max_chain"])
