"""Closed loop over single bones through the public facade: one client,
each request `bone.Humerus(path, validate=True)` over one of `distinct`
STL files written in set-up (cycled), then the reads a planner makes:
side, retroversion, neck-shaft, head radius, the canal, groove,
anatomic-neck, surgical-neck and transepicondylar landmarks, and
`apply_csys_canal_transepiconylar()`.  A request is timed from its start
to its last read."""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import answers as A
from benchmark.inputs import draw
from benchmark.reference import runner as ref

REF_BATCH = 8


class Run:
    def __init__(self, conf, traffic, seed, device, workdir, cfg):
        if conf["inputs"]["kind"] != "mesh":
            raise ValueError("the facade loop reads meshes")
        self.conf, self.seed, self.device = conf, seed, device
        self.workdir, self.cfg = workdir, cfg
        self.distinct = int(traffic["distinct"])
        self.unit = "bones"

    def make_inputs(self) -> None:
        """The meshes from the seed, as STL files under the run's
        directory."""
        self.params = draw.mesh_params(self.conf["inputs"], self.seed,
                                       self.distinct)
        self.paths = draw.write_meshes(self.params, self.workdir)

    def setup(self, split: dict) -> None:
        from benchmark.harness import programs as P

        t0 = time.perf_counter()
        self.make_inputs()
        split["inputs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        P.models(self.conf, self.cfg, self.device)
        split["models"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.step(0)
        P.synchronize(self.device)
        split["warmup"] = time.perf_counter() - t0

    def step(self, i: int):
        from benchmark.harness import programs as P

        k = i % self.distinct
        h = P.bone.Humerus(self.paths[k], config=self.cfg, validate=True,
                           device=self.device)
        reads = {
            "side": h.side(), "retroversion": h.retroversion(),
            "neckshaft": h.neckshaft(),
            "radius_curvature": h.radius_curvature(),
            "canal_axis": h.canal.axis(),
            "bg_axis": h.bicipital_groove.axis(),
            "anp_points": h.anatomic_neck.points(),
            "anp_axis_normal": h.anatomic_neck.axis_normal(),
            "sn_points": h.surgical_neck.points,
            "te_axis": h.trans_epiconylar.axis(),
        }
        reads["csys"] = h.apply_csys_canal_transepiconylar()
        return [(k, reads)]

    def free(self) -> None:
        pass

    @staticmethod
    def answer(raw) -> dict:
        return A.from_facade(raw)

    def reference(self, keys, control=None, sink=None) -> dict:
        from benchmark.reference.frozen.utils import geometry as geom

        keys = sorted(set(keys))
        specs = ref.ingest_files([self.paths[k] for k in keys], self.conf)
        groups = [keys[j:j + REF_BATCH]
                  for j in range(0, len(keys), REF_BATCH)]
        by_key = dict(zip(keys, specs))
        lms = ref.landmarks([[by_key[k] for k in g] for g in groups],
                            self.conf, self.device, control, sink)
        out = {}
        for g, lm in zip(groups, lms):
            for j, k in enumerate(g):
                def f(name):
                    return np.asarray(getattr(lm, name)[j], np.float64)
                canal, te = f("canal_axis"), f("te_axis")
                reads = {
                    "side": "left" if bool(lm.side_is_left[j]) else "right",
                    "retroversion": float(f("retroversion")),
                    "neckshaft": float(f("neckshaft")),
                    "radius_curvature": float(f("radius_curvature")),
                    "canal_axis": canal, "bg_axis": f("bg_axis"),
                    "anp_points": f("anp_points")[:int(lm.anp_n[j])],
                    "anp_axis_normal": f("anp_axis_normal"),
                    "sn_points": f("sn_points")[:int(lm.sn_n[j])],
                    "te_axis": te,
                    "csys": geom.host_f32(geom.construct_csys, canal, te),
                }
                out[k] = self.answer(reads)
        return out
