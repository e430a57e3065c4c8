"""Closed loop over a cohort on disk: one client, each step one whole
`cohort.process_cohort` pass over `distinct` STL files written in
set-up, `batch` bones a batch, the next batch's ingest prefetched by the
cohort's worker (the first batch's is not, as on every real cohort)."""

from __future__ import annotations

import time

from benchmark.harness import answers as A
from benchmark.inputs import draw
from benchmark.reference import runner as ref


class Run:
    def __init__(self, conf, traffic, seed, device, workdir, cfg):
        if conf["inputs"]["kind"] != "mesh":
            raise ValueError("the cohort loop reads meshes")
        self.conf, self.seed, self.device = conf, seed, device
        self.workdir, self.cfg = workdir, cfg
        self.batch = int(traffic["batch"])
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
        P.cohort.process_cohort(self.paths[:self.batch], config=self.cfg,
                                batch_size=self.batch, device=self.device)
        P.synchronize(self.device)
        split["warmup"] = time.perf_counter() - t0

    def step(self, i: int):
        from benchmark.harness import programs as P

        res = P.cohort.process_cohort(self.paths, config=self.cfg,
                                      batch_size=self.batch,
                                      device=self.device)
        return list(enumerate(res))

    def step_keys(self, i: int) -> list:
        """The reference's work keys of a pass: every batch."""
        return list(range(-(-self.distinct // self.batch)))

    def free(self) -> None:
        pass

    @staticmethod
    def answer(raw) -> dict:
        return A.from_cohort(raw)

    def reference(self, keys, control=None, sink=None) -> dict:
        keys = sorted(set(keys))
        specs = ref.ingest_files([self.paths[k] for k in keys], self.conf)
        groups = [keys[j:j + self.batch]
                  for j in range(0, len(keys), self.batch)]
        by_key = dict(zip(keys, specs))
        lms = ref.landmarks([[by_key[k] for k in g] for g in groups],
                            self.conf, self.device, control, sink)
        return {k: self.answer(A.cohort_row(lm, j, self.paths[k].stem))
                for g, lm in zip(groups, lms) for j, k in enumerate(g)}
