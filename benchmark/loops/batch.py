"""Closed loop over landmark batches: one client, each step one batch of
`batch` distinct inputs out of `distinct`, cycled in order.

Mesh inputs (a configuration of kind "mesh") are ingested by the port
from STL files and placed on the card in set-up; a step is one
`pipeline.batch.compute_landmarks_batch` call and the read-back
(`landmarks_to_numpy`).  CT inputs (kind "ct") are rendered on the host
in set-up; a step runs, for each volume, `pipeline.ct.segment_volume`
with the 3D UNet and `volume_to_spec` (marching tets, the copy, the
host weld and ingest), then one `stack_bones`, one
`compute_landmarks_batch` and the read-back.
"""

from __future__ import annotations

import time

from benchmark.harness import answers as A
from benchmark.inputs import draw
from benchmark.reference import runner as ref


class Run:
    def __init__(self, conf, traffic, seed, device, workdir, cfg):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device, self.workdir, self.cfg = device, workdir, cfg
        self.kind = conf["inputs"]["kind"]
        self.batch = int(traffic["batch"])
        self.distinct = int(traffic["distinct"])
        if self.distinct % self.batch:
            raise ValueError("distinct inputs must fill whole batches")
        self.n_batches = self.distinct // self.batch
        self.unit = "volumes" if self.kind == "ct" else "bones"

    # ------------------------------------------------------------ set-up
    def make_inputs(self) -> None:
        """The inputs from the seed: volumes in memory, or meshes as STL
        files under the run's directory."""
        if self.kind == "ct":
            self.params = draw.ct_params(self.conf["inputs"], self.seed,
                                         self.distinct)
            self.volumes = draw.ct_volumes(self.params)
        else:
            self.params = draw.mesh_params(self.conf["inputs"], self.seed,
                                           self.distinct)
            self.paths = draw.write_meshes(self.params, self.workdir)

    def setup(self, split: dict) -> None:
        from benchmark.harness import programs as P

        t0 = time.perf_counter()
        self.make_inputs()
        split["inputs"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.rf, self.seg = P.models(self.conf, self.cfg, self.device)
        split["models"] = time.perf_counter() - t0

        if self.kind == "mesh":
            t0 = time.perf_counter()
            specs = [P.ingest.load_bone(p, config=self.cfg)
                     for p in self.paths]
            self.bones = [P.B.stack_bones(specs[j * self.batch:
                                                (j + 1) * self.batch],
                                          self.device)
                          for j in range(self.n_batches)]
            split["ingest"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(1 if self.kind == "ct" else self.n_batches):
            self.step(i)
        P.synchronize(self.device)
        split["warmup"] = time.perf_counter() - t0

    # -------------------------------------------------------------- step
    def step(self, i: int):
        from benchmark.harness import programs as P

        b = i % self.n_batches
        first = b * self.batch
        if self.kind == "ct":
            max_tris = int(self.conf["inputs"]["max_tris"])
            specs = []
            for k in range(self.batch):
                vol, origin, spacing = self.volumes[first + k]
                seg, iso = P.ct.segment_volume(vol, "unet",
                                               device=self.device)
                specs.append(P.ct.volume_to_spec(
                    seg, origin, spacing, iso, config=self.cfg,
                    max_tris=max_tris, device=self.device))
                del seg
            bones = P.B.stack_bones(specs, self.device)
        else:
            specs, bones = None, self.bones[b]
        lm = P.B.landmarks_to_numpy(P.B.compute_landmarks_batch(
            bones, self.rf, cfg=self.cfg, seg_model=self.seg))
        return [(first + k, (lm, k, specs[k] if specs else None))
                for k in range(self.batch)]

    def step_keys(self, i: int) -> list:
        """The reference's work keys of step i: its batch."""
        return [i % self.n_batches]

    def free(self) -> None:
        for name in ("bones", "rf", "seg"):
            self.__dict__.pop(name, None)

    # ---------------------------------------------------------- answers
    @staticmethod
    def answer(raw) -> dict:
        lm, k, spec = raw
        out = A.from_landmarks(lm, k)
        return A.with_mesh(out, spec) if spec is not None else out

    def reference(self, keys, control=None, sink=None) -> dict:
        """The reference's answer for every input in `keys`, computed in
        the batches the program ran them in."""
        groups = sorted({k // self.batch for k in keys})
        idx = [list(range(g * self.batch, (g + 1) * self.batch))
               for g in groups]
        flat = [i for g in idx for i in g]
        if self.kind == "ct":
            specs = ref.ct_specs([self.volumes[i] for i in flat], self.conf,
                                 self.device, sink,
                                 keys=[i // self.batch for i in flat],
                                 control=control)
        else:
            specs = ref.ingest_files([self.paths[i] for i in flat], self.conf)
        by_key = dict(zip(flat, specs))
        lms = ref.landmarks([[by_key[i] for i in g] for g in idx], self.conf,
                            self.device, control, sink, keys=groups)
        out = {}
        for g, lm in zip(idx, lms):
            for k, i in enumerate(g):
                out[i] = self.answer((lm, k, by_key[i] if self.kind == "ct"
                                      else None))
        return out
