"""The frozen input generators equal the port's bit for bit (at the
commit that froze them)."""

import numpy as np
import pytest

from benchmark.inputs import ct_volume, draw, humerus
from benchmark.harness import spec as S


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_humerus_equals_the_ports(seed):
    from shoulder_tpu_torch.io import testdata

    rng = np.random.default_rng(seed)
    kw = dict(length=float(rng.uniform(250, 310)),
              head_radius=float(rng.uniform(20, 27)),
              neck_shaft_deg=float(rng.uniform(125, 145)),
              retroversion_deg=float(rng.uniform(15, 40)),
              side=("left", "right")[seed % 2], n_rings=40, n_theta=24,
              head_flattening=0.1, osteophyte_amp=1.0, surface_noise=0.2)
    got = humerus.synthetic_humerus(
        rng_transform=np.random.default_rng(seed), return_head_label=True,
        **kw)
    want = testdata.synthetic_humerus(
        rng_transform=np.random.default_rng(seed), return_head_label=True,
        **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tg, tw = humerus.truth_geometry(**kw), testdata.truth_geometry(**kw)
    assert tg.keys() == tw.keys()
    assert all(np.array_equal(tg[k], tw[k]) for k in tg)


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_ct_volume_equals_the_ports(seed):
    from shoulder_tpu_torch.pipeline import ct

    conf = S.config(S.load_benchmark(), "ct_unet")
    inputs = dict(conf["inputs"], shape=[48, 24, 24], pitch_mm=6.5)
    p = draw.ct_params(inputs, seed, 2)[1]
    got = ct_volume.synth_ct_volume(**p)
    want = ct.synth_ct_volume(**p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_draws_follow_the_seed_and_keep_sizes():
    conf = S.config(S.load_benchmark(), "mesh_unet")
    a = draw.mesh_params(conf["inputs"], 2**33 + 1, 6)
    assert a == draw.mesh_params(conf["inputs"], 2**33 + 1, 6)
    b = draw.mesh_params(conf["inputs"], 2**33 + 2, 6)
    assert a != b
    assert [p["side"] for p in a] == ["left", "right"] * 3
    for p in a + b:
        assert 250 <= p["length"] <= 310 and 20 <= p["head_radius"] <= 27
        assert (p["n_rings"], p["n_theta"]) == (160, 128)
    v, f = draw.mesh(a[0])
    assert f.shape == (40960, 3)
