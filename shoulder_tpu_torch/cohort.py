"""Cohort processing: many bones through one device, batch by batch.

Port of shoulder_tpu/cohort.py.  Bones run in fixed-size batches (a short
last batch pads with a repeat of its last bone; results drop the pad).
While the device runs one batch, a pool of host threads ingests the
bones of the next two (STL parse, OBB, head detection), one task a
bone, in the order of the paths, so a thread that finishes one chunk's
last bone starts on the next chunk's; for each chunk a prefetch thread
waits for its bones and stacks them into page-locked host memory.
Neither touches a stream or launches anything.  The pool's size follows
the CPUs the process may use (`_pool_size`).  Each batch runs through
parallel/mesh.py's sharded pipeline: the main thread splits it over the
mesh's devices (one shard on `device` when no mesh is given), copies
each shard with `non_blocking=True` on the current stream, and reads
back only the SUMMARY_FIELDS, in one copy per shard.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from shoulder_tpu_torch import config as config_mod
from shoulder_tpu_torch.config import PipelineConfig
from shoulder_tpu_torch.utils import trace

# the per-bone result dict below reads only these Landmarks fields
SUMMARY_FIELDS = (
    "side_is_left", "retroversion", "neckshaft", "radius_curvature",
    "neck_z", "canal_axis", "te_axis", "bg_axis", "anp_plane_point",
    "anp_plane_normal", "qc_rf_pos_frac", "qc_mask_area_frac",
    "qc_sphere_resid", "qc_canal_fit_rms", "qc_slice_overflow",
    "qc_peak_overflow", "qc_open_edges",
)


# chunks whose ingest runs ahead of the main thread: the one it waits
# for next and the one after, so the pool does not stop at a chunk's end
AHEAD = 2
# threads past which a pass of mesh_unet.cohort64 stopped gaining on the
# card's 8-core host (PERF.md, section 6): numpy's head detection
# and presort hold the GIL
POOL_CAP = 4


def _pool_size(n_bones: int) -> int:
    """Host threads that ingest a cohort of `n_bones`: the CPUs this
    process may use, less one for the main thread's dispatch, at most
    `n_bones` and POOL_CAP; 1 on one CPU."""
    usable = len(os.sched_getaffinity(0))
    return max(1, min(usable - 1, n_bones, POOL_CAP))


class _Ingest:
    """One pass's bone ingest on a pool of threads, one task a bone.  A
    bone whose ingest starts while another of the pass is still being
    ingested counts in `cohort.ingest_overlap`."""

    def __init__(self, pool, proximal, config):
        self.pool, self.proximal, self.config = pool, proximal, config
        self.running = 0
        self.lock = threading.Lock()
        # the counter exists from the first pass on, so a pass without
        # overlap reads 0
        trace.count("cohort.ingest_overlap", 0)

    def submit(self, path, parent, request):
        """`ingest.load_bone(path)` as a task whose spans are children of
        the span `parent` of another thread."""
        return self.pool.submit(self._load, path, parent, request)

    def _load(self, path, parent, request):
        from shoulder_tpu_torch.io import ingest

        with self.lock:
            overlap = self.running > 0
            self.running += 1
        if overlap:
            trace.count("cohort.ingest_overlap")
        try:
            with trace.under(parent, request):
                return ingest.load_bone(path, proximal=self.proximal,
                                        config=self.config)
        finally:
            with self.lock:
                self.running -= 1


def _prep_chunk(bones, batch_n, pin):
    """Prefetch-thread stage: wait for one chunk's bones (futures of
    BoneSpecs, in the chunk's order) and stack them on the host, one
    batch per padding: every bone at the pass's config or, with none, at
    the smallest padding that holds it, so that a bone's row does not
    depend on the sizes of its batch-mates.  Returns (positions in the
    chunk, specs, host batch) for each padding, in order of first use.

    Short batches pad with a repeat of the last bone.
    """
    from shoulder_tpu_torch.pipeline import batch as B

    specs = [bone.result() for bone in bones]
    trace.count("cohort.bones_ingested", len(specs))
    groups = {}
    for i, spec in enumerate(specs):
        groups.setdefault(spec.config, []).append(i)
    out = []
    for idx in groups.values():
        group = [specs[i] for i in idx]
        padded = group + [group[-1]] * (batch_n - len(group))
        out.append((idx, group, B.stack_host(padded, pin=pin)))
    return out


def _prefetch(span_id, request, *args):
    """`_prep_chunk` in a prefetch thread as the span `cohort.prefetch`
    (id `span_id`, the parent of its bones' spans) of the chunk's request:
    (the span's id, its result)."""
    with trace.span("cohort.prefetch", request=request,
                    span_id=span_id) as span_id:
        return span_id, _prep_chunk(*args)


def _summary(lms, n_real: int) -> dict:
    """The SUMMARY_FIELDS of a batch, given as its shards' Landmarks (one
    on a one-device mesh), in one device-to-host copy per shard, as
    numpy arrays of the first n_real bones (float32; flags as 0/1)."""

    def rows(lm):
        n = lm.neck_z.shape[0]
        return torch.cat([getattr(lm, f).reshape(n, -1).to(torch.float32)
                          for f in SUMMARY_FIELDS], dim=1).cpu().numpy()

    parts = [getattr(lms[0], f) for f in SUMMARY_FIELDS]
    flat = np.concatenate([rows(lm) for lm in lms])[:n_real]
    out, col = {}, 0
    for f, p in zip(SUMMARY_FIELDS, parts):
        width = p[0].numel()
        out[f] = flat[:, col:col + width].reshape((n_real,) + p.shape[1:])
        col += width
    return out


def process_cohort(
    stl_paths: Sequence,
    proximal: bool = False,
    config: PipelineConfig | None = None,
    device_mesh=None,
    chunk: int = 150,
    batch_size: int = 8,
    device="cuda",
) -> list[dict]:
    """Run the full landmark pipeline over a cohort of STL files.

    Returns one dict per bone: name, side, retroversion, neckshaft,
    radius_curvature, canal/TE/groove axes (CT frame), neck_z, and QC.
    With `device_mesh` (parallel.mesh.bone_mesh) each batch shards over
    its devices; the batch is then at least one bone per device and a
    multiple of their number.  Without one, the batch runs on `device`
    alone (default the card; there is no CPU fallback).  `batch_size`
    fixes the batch shape; the cohort streams through it with the next
    two batches' ingest prefetched on a pool of host threads.  Without
    `config`, each bone runs at the smallest of `config.PADDINGS` that
    holds it: a chunk of `batch_size` bones that needs two paddings runs
    as two batches.  Rows keep the order of `stl_paths`; an ingest that
    raises raises here.
    """
    from shoulder_tpu_torch.bone import _device
    from shoulder_tpu_torch.parallel import mesh as pmesh

    if not len(stl_paths):
        return []
    if device_mesh is None:
        device_mesh = pmesh.bone_mesh([_device(device)])
    n_dev = len(device_mesh.devices)
    batch_size = max(batch_size, n_dev)
    batch_size += (-batch_size) % n_dev
    pin = any(d.type == "cuda" for d in device_mesh.devices)
    fns = {}

    def sharded(cfg):
        """The sharded pipeline at `cfg`, built at its first batch."""
        if cfg not in fns:
            fns[cfg] = pmesh.sharded_landmark_fn(
                device_mesh, proximal=proximal, cfg=cfg, chunk=chunk)
        return fns[cfg]

    # models first, so the devices are initialized before a prefetch
    # thread pins
    sharded(config or config_mod.PADDINGS[0])

    path_chunks = [
        list(stl_paths[i:i + batch_size])
        for i in range(0, len(stl_paths), batch_size)
    ]
    specs, sums, order = [], [], []
    # one request per chunk: its prefetch in a prefetch thread, holding the
    # spans of its bones' ingest in the pool, the main thread's wait for it
    # (caused by that prefetch; its time also in the always-on counter
    # cohort.wait_ns), its batch and its read-back
    requests = [trace.new_request() for _ in path_chunks]
    pool = ThreadPoolExecutor(_pool_size(len(stl_paths)),
                              thread_name_prefix="cohort-ingest")
    stager = ThreadPoolExecutor(AHEAD, thread_name_prefix="cohort-prefetch")
    bones = _Ingest(pool, proximal, config)

    def prefetch(ci):
        """Chunk ci's bones onto the pool, after every earlier chunk's,
        and their wait and stacking onto a prefetch thread."""
        span_id = trace.new_span_id()
        futures = [bones.submit(p, span_id, requests[ci])
                   for p in path_chunks[ci]]
        return stager.submit(_prefetch, span_id, requests[ci], futures,
                             batch_size, pin)

    try:
        ahead = collections.deque(
            prefetch(ci) for ci in range(min(AHEAD, len(path_chunks))))
        for ci in range(len(path_chunks)):
            with trace.span("cohort.wait", request=requests[ci]):
                t0 = time.perf_counter_ns()
                prefetch_id, batches = ahead.popleft().result()
                trace.count("cohort.wait_ns", time.perf_counter_ns() - t0)
                trace.caused_by(prefetch_id)
            runs = []
            for idx, chunk_specs, host in batches:
                # `host` stays referenced until the readback below has
                # synchronized, so its pinned pages outlive the async copy
                with trace.span("cohort.batch", request=requests[ci]):
                    runs.append((idx, chunk_specs, host, sharded(
                        chunk_specs[0].config)(
                            pmesh.shard_bones(host, device_mesh))))
            if ci + AHEAD < len(path_chunks):
                # later bones ingest while the device runs this chunk; they
                # start once it is dispatched, so that a pool running ahead
                # leaves the dispatch the GIL
                ahead.append(prefetch(ci + AHEAD))
            for idx, chunk_specs, _, lms in runs:
                with trace.span("cohort.summary", request=requests[ci]):
                    sums.append(_summary(lms, len(chunk_specs)))
                specs.extend(chunk_specs)
                order.extend(ci * batch_size + i for i in idx)
    finally:
        # on an error, bones not yet started are dropped; the threads end
        # with their current bone
        pool.shutdown(cancel_futures=True)
        stager.shutdown(cancel_futures=True)

    lm = {f: np.concatenate([s[f] for s in sums]) for f in SUMMARY_FIELDS}
    out = []
    for i, spec in enumerate(specs):
        out.append(
            {
                "name": spec.name,
                "side": "left" if bool(lm["side_is_left"][i]) else "right",
                "retroversion_deg": float(lm["retroversion"][i]),
                "neckshaft_deg": float(lm["neckshaft"][i]),
                "radius_curvature_mm": float(lm["radius_curvature"][i]),
                "neck_z": float(lm["neck_z"][i]),
                "canal_axis_ct": np.asarray(lm["canal_axis"][i]),
                "te_axis_ct": np.asarray(lm["te_axis"][i]),
                "bg_axis_ct": np.asarray(lm["bg_axis"][i]),
                "anp_plane_point_ct": np.asarray(lm["anp_plane_point"][i]),
                "anp_plane_normal_ct": np.asarray(
                    lm["anp_plane_normal"][i]
                ),
                "qc": {
                    "rf_pos_frac": float(lm["qc_rf_pos_frac"][i]),
                    "mask_area_frac": float(lm["qc_mask_area_frac"][i]),
                    "sphere_resid_mm": float(lm["qc_sphere_resid"][i]),
                    "canal_fit_rms_mm": float(lm["qc_canal_fit_rms"][i]),
                    "slice_band_overflow": bool(
                        lm["qc_slice_overflow"][i]
                    ),
                    "peak_capacity_overflow": bool(
                        lm["qc_peak_overflow"][i]
                    ),
                    "open_edges": bool(lm["qc_open_edges"][i]),
                },
            }
        )
    # back to the order of stl_paths
    return [out[i] for i in np.argsort(order)]


def cohort_summary(results: list[dict]) -> dict:
    """Aggregate stats over a processed cohort."""
    retro = np.array([r["retroversion_deg"] for r in results])
    ns = np.array([r["neckshaft_deg"] for r in results])
    rad = np.array([r["radius_curvature_mm"] for r in results])
    return {
        "n": len(results),
        "retroversion_mean": float(np.nanmean(retro)),
        "retroversion_std": float(np.nanstd(retro)),
        "neckshaft_mean": float(np.nanmean(ns)),
        "neckshaft_std": float(np.nanstd(ns)),
        "radius_mean": float(np.nanmean(rad)),
        "left_fraction": float(
            np.mean([r["side"] == "left" for r in results])
        ),
        "qc_flags": int(
            sum(r["qc"]["slice_band_overflow"] or r["qc"]["open_edges"]
                or r["qc"]["peak_capacity_overflow"]
                for r in results)
        ),
    }
