"""Cohort processing: many bones through one device, batch by batch.

Port of shoulder_tpu/cohort.py.  Bones run in fixed-size batches (a short
last batch pads with a repeat of its last bone; results drop the pad).
While the device runs one batch, a worker thread ingests the next (STL
parse, OBB, head detection) and stacks it into page-locked host memory;
the worker touches no stream and launches nothing.  Each batch runs
through parallel/mesh.py's sharded pipeline: the main thread splits it
over the mesh's devices (one shard on `device` when no mesh is given),
copies each shard with `non_blocking=True` on the current stream, and
reads back only the SUMMARY_FIELDS, in one copy per shard.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from shoulder_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig

# the per-bone result dict below reads only these Landmarks fields
SUMMARY_FIELDS = (
    "side_is_left", "retroversion", "neckshaft", "radius_curvature",
    "neck_z", "canal_axis", "te_axis", "bg_axis", "anp_plane_point",
    "anp_plane_normal", "qc_rf_pos_frac", "qc_mask_area_frac",
    "qc_sphere_resid", "qc_canal_fit_rms", "qc_slice_overflow",
    "qc_peak_overflow", "qc_open_edges",
)


def _prep_chunk(paths, proximal, config, batch_n, pin):
    """Worker-thread stage: ingest and stack one batch on the host.

    Short batches pad with a repeat of the last bone.
    """
    from shoulder_tpu_torch.io import ingest
    from shoulder_tpu_torch.pipeline import batch as B

    specs = [
        ingest.load_bone(p, proximal=proximal, config=config) for p in paths
    ]
    padded = specs + [specs[-1]] * (batch_n - len(specs))
    return specs, B.stack_host(padded, pin=pin)


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
    config: PipelineConfig = DEFAULT_CONFIG,
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
    batch's ingest prefetched.
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
    # models first, so the devices are initialized before the worker pins
    sharded = pmesh.sharded_landmark_fn(device_mesh, proximal=proximal,
                                        cfg=config, chunk=chunk)

    path_chunks = [
        list(stl_paths[i:i + batch_size])
        for i in range(0, len(stl_paths), batch_size)
    ]
    specs, sums = [], []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(_prep_chunk, path_chunks[0], proximal, config,
                        batch_size, pin)
        for ci, paths in enumerate(path_chunks):
            chunk_specs, host = fut.result()
            if ci + 1 < len(path_chunks):
                # the next batch's ingest runs while the device runs this one
                fut = ex.submit(_prep_chunk, path_chunks[ci + 1], proximal,
                                config, batch_size, pin)
            # `host` stays referenced until the readback below has
            # synchronized, so its pinned pages outlive the async copy
            sums.append(_summary(
                sharded(pmesh.shard_bones(host, device_mesh)),
                len(chunk_specs)))
            specs.extend(chunk_specs)

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
    return out


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
