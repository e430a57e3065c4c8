"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: a CUDA card must be present (there is no CPU fallback);
  2. build: compile every kernel of csrc/ into one library with nvcc (one
     nvcc per source, run together) and print ptxas's register, spill and
     shared-memory lines; at the same time, g++ builds the native host
     ingest (csrc/ingest.cpp, csrc/obb.cpp; io/native.py), and a failed
     build of either fails the run;
  3. walk kernel vs plain: the standalone walk kernel (csrc/chain_walk.cu)
     against its plain PyTorch version on random loop rows, rows whose
     chains merge, cycle, leave nc or the row or reach a negative
     successor, an empty slice, and the real (succ, crossed) rows of bone
     0's three slice stacks (made by the plain compaction on the card):
     exact equality of n, is_start and order[:n]; both timed at the
     proximal stack's shape (600 x 384) and at 8 bones' rows (4800 x
     384), with the bound;
  4. pipeline: ingest 8 synthetic humeri (4 left, 4 right) with the port's
     own native ingest, bone 0 also through the numpy oracle
     (load_indexed's arrays and the BoneSpec's vertices, faces, neighbors
     and face_orig equal, obb_transform and z_bounds within 1e-6; both
     times printed), and run compute_landmarks_batch at DEFAULT_CONFIG
     with the UNet segmenter on the card, one program for the batch,
     twice: the first call runs each stage eagerly and captures it as a
     CUDA graph (pipeline/graphs.py; its raw-loop inputs and any plain
     compaction recorded), the second, counted, replays every graph;
     every bone must get its side right and land within 3 deg / 3 deg /
     1 mm of the constructed neck-shaft angle, retroversion and head
     radius, with no slice overflow; in the replayed call (the port's
     kernels counted by name from a profile of the card, as every phase
     below counts them: a replay calls no kernel wrapper) the fused
     slice-stack kernel must have run exactly once per stack for the
     whole batch (3),
     the raw-loop kernel (csrc/slice_raw.cu) once for the batch's
     surgical-neck planes, the sphere score kernel twice and the sphere
     fit kernel 30 times (the batch's one sphere_segment call: two picks,
     two passes for each of 2 seed fits and 12 IRLS passes, one for each
     of 2 basin sigmas), the standalone walk and the plain compaction
     never; one bone runs again on the CPU (plain
     composition) and must agree within 0.75 deg / 0.75 mm, bench.py's
     gate;
  5. slice-stack kernel vs plain: each of phase 4's three batched
     launches equals the launches of its 8 bones one by one, bit for bit,
     and agrees with the batched plain composition on the card, as do
     bone 0's edge planes (above and below the bone, at exact vertex
     heights) and a k = 64 call that overflows: overflow and open_edges
     equal, contours and centroids within 1e-3 mm, areas within 0.01
     mm^2; the rows whose best loop differs are counted; on the same
     cases the kernel's own walk (its timed build hands it out) equal to
     the plain walk of the plain compaction's rows, exactly (rows
     compared and disagreement printed); kernel and plain
     times per stack of the batch (and the kernel's per stack of bone 0
     alone), and each stage's time inside a block from the kernel's
     timed build;
 5b. raw-loop kernel vs plain: phase 4's batched launch equals its 8
     bones' own launches bit for bit, and so does the same planes' launch
     at the CT shape (band 6144, k 1024, max_chain 1024: a block of 1024
     threads); on phase 4's 8 surgical-neck planes (central, as the path
     calls it, and largest), bone 0's edge planes (both selects), both at
     the main path's shape and at the CT shape, and the 8 planes at k 24
     (every plane overflows) the kernel against the plain composition on
     the card: n, overflow and the loop equal (area within 0.01 mm^2,
     centroid within 1e-3 mm; the planes whose loop differs counted, none
     allowed), points within 1e-5 mm (bit for bit expected: the largest
     difference printed); kernel and plain times of phase 4's call and of
     its planes at the CT shape, their bounds, and each stage's
     microseconds inside a block from the kernel's timed build
     (slicing.RAW_STAGES);
 5c. sphere kernels vs plain: phase 4's sphere_segment call (its 8 bones'
     polar points, the UNet's masks) run again with every call of the two
     kernels (csrc/sphere_score.cu, csrc/sphere_fit.cu, through
     ops/sphere.py) recorded, equal to phase 4's result bit for bit; each
     recorded call's kernel result against its plain PyTorch version on the
     same inputs: the scores of the hypotheses a pick may take within
     1e-5 relative (the others' error printed) and the same pick or a tie
     of the plain scores (ties counted and printed), each seed fit's and
     IRLS pass's sphere and each basin sigma within 1e-3 mm; the whole
     call with the plain versions on the card: every bone's refined
     sphere within 1e-3 mm, its mask on at least 99.9 % of its pixels;
     each batched kernel call equal to its bones' own calls bit for bit,
     and each bone's sphere_segment alone against its batch row (bit for
     bit counted, held to the same tolerances); kernel, plain and bound
     times of the score (round B), a given-weight fit, an IRLS pass and a
     basin sigma, for the batch and bone 0 alone, the fits beside torch.bmm
     of the same (A w)^T [A | f] product;
  6. timing: a batch of 1 and a batch of 8 at DEFAULT_CONFIG with the
     UNet, on the main path (each stage a CUDA graph's replay) and with
     the stages eager (landmarks._stages), each profiled once (kernel
     launches: the profiler's
     cudaLaunchKernel and every launch API call, plus the port's own
     kernels' launches from the host, which it does not count; device
     busy time and idle share), twice under
     torch.cuda.set_sync_debug_mode("warn")
     (the second run's synchronizing calls counted: a process's first run
     so watched counts one more), and 5 warm synchronized runs (p50,
     and the peak memory above what was resident before them), the
     graphed numbers printed beside the eager ones with the graphs'
     counters (replays, no fallback, no more synchronizing calls than
     eager); each batch, stages eager,
     also profiled and counted with the plain raw loop the parent tree ran
     on the card, and 6 synchronized runs of each timed in turns (plain,
     kernel, kernel, plain, ...), both printed, the kernel's
     synchronizing calls no more than the plain one's; on the main path,
     launches per batch of 8 at most 1.25x a batch of 1's, synchronizing
     calls no more and at most 3; the
     largest batch the card holds, linear in B from the two peaks;
  7. facade: the README flow through shoulder_tpu_torch.Humerus on the card
     (canal on z through the origin, metrics equal to phase 4's bone 0
     within 0.05 deg / 0.05 mm), the osteotomy probes, a plot, the three
     slice views, and a ProximalHumerus checked against the same bone on
     the CPU; (slice-stack, raw-loop) launches (3, 1) / (3, 0) / (2, 1),
     walk launches 0;
  8. cohort: process_cohort over the 8 STLs in batches of 4 (two batches,
     one prefetch); each bone equal to phase 4 within 0.05 deg / 0.05 mm;
     6 slice-stack launches (3 per batch), 2 raw-loop launches, no walk
     launch.
  9. CT: four 1.0 mm CT volumes (320 x 144 x 144, 2 left and 2 right)
     from pipeline.ct.synth_ct_volume through the 3D UNet, marching tets
     and the weld on the card and host, then one compute_landmarks_batch
     of 4 at DEFAULT_CONFIG's widths with the CT mesh sizes (k 1024, band
     6144, max_chain 1024); every mesh watertight, no slice overflow, the
     UNet's mask against the HU threshold at IoU >= 0.85, each bone within
     3.5 deg / 4.5 deg / 1.5 mm / 1.5 mm (neck-shaft, retroversion,
     radius, neck_z) of the direct mesh of the same generator bone
     (CT_GATES), exactly 3 slice-stack launches (one per stack for the
     batch), 1 raw-loop launch and no walk launch; the card's marching
     tets against the
     CPU's on one threshold surface (equal count and weld, 1e-4 mm), the
     card's UNet against the CPU's (mask agreement >= 99.9 %), and each
     of the 3 batched launches equal to its 4 bones' own launches bit for
     bit and to the batched plain composition with phase 5's tolerances,
     and its walk to the plain walk exactly, as in phase 5; the raw-loop
     launch on the 4 CT planes (k 1024, band 6144, max_chain 1024) equal
     to its bones' own launches bit for bit and to the plain composition
     as in phase 5b; per-volume times with the UNet's and marching tets'
     bounds, and the kernels' times at the CT sizes, the raw loop's with
     its stages.
 10. training: a corpus of 8 random synthetic humeri by
     tools/make_unet_corpus_torch.build_corpus at DEFAULT_CONFIG on the
     card (exactly 2 slice-stack launches per extracted bone, no
     raw-loop or walk launch, images finite, mask fractions inside (0.05, 0.95), the first
     bone's two stacks against the plain composition with phase 5's
     tolerances); the articular UNet at full width (512 x 512, batch 16):
     30 `train_mixture` steps on that corpus from Flax-like random
     weights (losses finite, the mean of the last five below the mean of
     the first five), one step on a fixed batch on the card and on the
     CPU (loss within 2e-2 relative; every parameter's gradient within
     5e-2 relative L2 in bf16 from random weights, in float32 and in bf16
     from the shipped weights, where the gradient is a small residual of
     sums that cancel; and the card's bf16 gradient there no farther
     from its own float32 one than 1.25x the CPU's is from the CPU's),
     then save_params -> load_model -> segment_image on
     phase 4's bone 0 image equal to the in-memory model's mask, and a
     zero-step save of the shipped weights giving phase 4's bone 0 its
     metrics of its own run in phase 4 again, exactly; the CT UNet: 10
     `train` steps at 64 x 48 x 48 from
     the shipped weights and 10 from random ones (losses finite, the
     second run's last below its first), the trained weights served by
     `apply_volume` after a save; ms per training step (CUDA events, 10
     warm steps), peak memory and the steps' convolution bounds for both.
     cuDNN's TF32 is off (the package sets it so): float32 convolutions
     run in full float32, the bf16 ones accumulate in float32.
 11. accuracy cohorts: tests/test_accuracy_gate.py's healthy and arthritic
     cohorts of 8 (default_rng(2026), in-memory meshes through the port's
     spec_from_arrays), one compute_landmarks_batch each at DEFAULT_CONFIG
     on the card: every side right, both cohorts inside that test's
     BOUNDS, each healthy bone within 0.75 deg / 0.75 mm of the JAX
     package's row in tools/eval_accuracy_results.json, and each
     arthritic bone within 0.3 deg / 0.3 deg / 0.05 mm of its row (the
     CPU's margin; see ACC_ARTHRITIC_GATE).
 12. mesh: parallel.mesh.bone_mesh() over the card (one device):
     sharded_landmark_fn on phase 4's batch equal to phase 4 exactly,
     with 3 slice-stack launches and 1 raw-loop launch; cohort_stats of
     it against numpy's
     nanmean / nanstd; process_cohort(device_mesh=...) over the 8 STLs in
     batches of 4 equal to phase 8's results exactly.
 13. mesh training and sections: models.unet_train.train(mesh=bone_mesh(),
     steps=3) at full width (512 x 512, batch 8) equal to three
     one-device train_steps on the same draws bit for bit (losses and
     every parameter; cuDNN deterministic for both) and dryrun(bone_mesh()) finite; on phase 4's 8 bones, the
     card against the same calls on the CPU: the full-set slice_raw
     (largest and central loops at two heights, counts equal, points
     within 1e-3 mm, areas within 0.01 mm^2), sorted_geom without
     face_orig on heights rounded to 0.5 mm (ties everywhere) bit for
     bit, plane_section_points through each bone's anatomic-neck plane
     (at most 2 crossing decisions differ, points within 1e-3 mm),
     first_hit along the plane's normal with and without face_valid (a
     seeded three quarters of the faces)
     (hits equal, points within 1e-3 mm) and fit_circle on the largest
     loops (within 1e-4 relative); no kernel launch.
 14. robustness, the JAX package's checks that run on the CPU there, each
     batch exactly 3 slice-stack launches and 1 raw-loop launch:
     (a) tests/test_rigid_invariance.py's bone under its 6 rigid frames
     (default_rng(42)), one batch at DEFAULT_CONFIG with the UNet, each
     frame one native OBB search: the spread of neck-shaft, retroversion
     and radius each < 0.5, no side flip, anatomic-neck plane points
     mapped back within 1.0 mm and normals within 0.5 deg;
     (b) phase 11's cohorts again under segmenter="sphere" (its BoneSpecs
     reused): every side as the JAX row calls it (the sphere arm calls 3
     of 8 arthritic sides wrong there), healthy bones within 0.75 deg /
     0.75 mm and arthritic bones within ACC_ARTHRITIC_GATE of their rows in
     tools/eval_accuracy_sphere.json; then tests/test_segmenter_ab.py's
     tripwire (default_rng(77), 4 bones per cohort, both arms): the UNet
     arm no worse than the sphere arm by AB_MARGIN on |max| error;
     (c) tests/test_ct_pitch_sweep.py's bone as its direct mesh and as a
     1.0, a 1.5 and a 2.0 mm CT volume cut at 300 HU, segmented and meshed
     on the card, a batch of 2 each at tools/eval_ct_pitch.py's config
     (band 6144, k 1024, so the raw loop's block of 1024 threads): the
     side as the JAX row in tools/eval_ct_pitch_results.json calls it (the
     same at 1.0 and 1.5 mm, wrong at 2.0), the deltas (neck_z's too)
     within 0.75 of the row and, at 1.0 and 1.5 mm, inside PITCH_BOUNDS;
     (d) phase 4's batch and tests/test_arthritic_cohort.py's cohort
     (default_rng(7), tiny_config) under utils.nan_trap (every aten call's
     and kernel launch's floating-point outputs checked for NaN,
     uninitialized memory filled with NaN), after phase 6's sync counts:
     no site, landmarks bit for bit the untrapped run's, and that test's
     four checks on the cohort.
 15. measurement entry points: bench_torch.run_bench at DEFAULT_CONFIG,
     batch 8, 5 reps (bench.py's protocol: one bone replicated, forest
     and UNet loaded once, a warm-up, one run's launches and
     synchronizing calls counted, 5 synchronized reps): bench.py's gate
     passed, 3 slice-stack and 1 raw-loop launches per batch run, no walk
     launch or plain compaction, launches and synchronizing calls equal
     to phase 6's batch of 8; its JSON line and p50 printed beside phase
     6's p50; then tools/bench_cohort_torch.run_cohort with the tool's
     defaults (4 synthetic bones x 16 = 64, batch 8, a cold and a warm
     pass): 64 rows, each side its synthetic truth, 3 and 1 launches per
     batch.
 16. accuracy evidence, the port's twins of the JAX package's tools, on
     in-memory bones: (a) tools/eval_articular_torch.py's healthy and
     arthritic cohorts of 8 (seeds 11 and 13) at DEFAULT_CONFIG with the
     UNet, 4 bones per eval batch, each batch exactly 2 slice-stack
     launches (k 512, the JAX tool's slots) and 1 raw-loop launch, no
     walk launch or plain compaction; each bone's row against its JAX
     row in tools/eval_articular_rows_jax.json: the three IoUs within
     0.01, the plane, neck-shaft and radius errors of both segmenters
     within 0.75 deg / 0.75 deg / 0.75 mm (healthy) or ACC_ARTHRITIC_GATE
     (arthritic), the constructed neck-shaft equal; the per-cohort
     summaries printed beside the JAX ones; (b)
     tools/eval_arthritic_ab_torch.py's cohort (default_rng(42), 8 bones,
     the same draws as the JAX rows), both arms one batch each: each
     arm's neck-shaft within 0.3 deg and qc_sphere_resid within 0.05 mm
     of its JAX row; (c) tools/eval_accuracy_torch.py's cohorts, which
     are phase 11's: its default arm bit for bit phase 11's landmarks and
     its sphere arm phase 14b's, every field.

Phases 4, 7-11 and 14-16 ingest: in each, every bone takes one native
ingest where it comes from an STL or a soup, and one native OBB search,
and the numpy oracle runs never; each prints its ingest split (ms per
bone of the STL read and weld, the soup weld, the OBB, head detection
and the presort).

The bone STLs live in one temporary directory for the whole run.

The last lines: a JSON object of the host ingest per phase (counts,
ms per bone of each stage, the host's CPU, phase 4's native and numpy
times of bone 0), phase 13's and phase 11's results, phase 14's results,
phase 15's results, phase 16's results, a JSON object describing each
kernel (launches in the main path's run and per phase, disagreement with
the plain version, times, bound), the card's name and power limit as nvidia-smi gives them,
and {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import dataclasses
import importlib
import importlib.util
import inspect
import io
import json
import os
import tempfile
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from torch.profiler import ProfilerActivity, profile

from shoulder_tpu_torch.utils import bench
from shoulder_tpu_torch.utils.bench import card

BATCH = 8
REPS = 5
TRUTH = dict(neck_shaft_deg=135.0, retroversion_deg=25.0, head_radius=24.0)
STACKS = ("full", "proximal", "distal")
# one H100 SXM (NVIDIA's data sheet): HBM rate, float32 rate outside the
# tensor cores and dense bf16 tensor-core rate, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# the tolerances of tests/test_slice_kernel.py:179-186
TOL_MM, TOL_MM2 = 1e-3, 0.01
# phase 9: tools/eval_ct_pitch.py's field of view at 1.0 mm, its bone
# (tests/test_ct_path.py's) in four poses, its padded sizes
CT_PITCH = 1.0
CT_SHAPE = (320, 144, 144)
CT_BONE_KW = dict(head_radius=26.0, shaft_radius=10.0, metaphysis_scale=0.6,
                  groove_depth=4.5, groove_width_deg=20.0)
CT_POSES = (("left", 20.0, 130.0), ("right", 30.0, 140.0),
            ("left", 30.0, 140.0), ("right", 20.0, 130.0))
CT_MAX_TRIS = 400000
CT_IOU = 0.85
# CT bone vs the direct mesh: neck-shaft, retroversion, radius, neck_z
# (tests/test_ct_path.py:112-125).  Neck-shaft is 3.5 deg, not the test's
# 2.0: at this setting the left 30/140 pose sits 2.59-2.80 deg from its
# mesh for every noise seed tried, the others within 0.38
# (tools/eval_ct_poses_torch.py), and the JAX package gives the same
# offset on the same CT mesh (tools/compare_ct_meshes_jax.py); 3.5 is
# that + 25 %, the margin the test gave retroversion
CT_GATES = (("neckshaft", 3.5), ("retroversion", 4.5),
            ("radius_curvature", 1.5), ("neck_z", 1.5))
# phase 11: tests/test_accuracy_gate.py's cohorts and BOUNDS (degrees /
# mm), and bench.py's 0.75 gate per healthy bone against the JAX rows
ACC_PER_COHORT = 8
ACC_BOUNDS = {
    "healthy": dict(ns=3.0, rv=4.0, rad=1.5, mean_ns=2.0, mean_rv=2.0),
    "arthritic": dict(ns=30.0, rv=25.0, rad=3.5, mean_ns=5.0, mean_rv=5.0),
}
ACC_GATE = 0.75
# the arthritic bones against their JAX rows (neck-shaft, retroversion deg,
# radius mm): the CPU's margin.  The card lay up to 0.640 / 2.444 / 0.101
# from them (bone 5, in the support gate's rescue branch) while cuDNN's
# bf16 convolutions rounded their sums before the bias was added;
# tools/arthritic_divergence_torch.py traced it to the UNet's masks, and
# models/unet._RoundOnce rounds once
ACC_ARTHRITIC_GATE = (0.3, 0.3, 0.05)
# phase 14a: tests/test_rigid_invariance.py's bone under its frames, and
# its gates: the spread of each metric, plane points mapped back (mm) and
# the normals' angle (deg)
RIGID_FRAMES = 6
RIGID_BONE = dict(length=285.0, head_radius=23.5, neck_shaft_deg=133.0,
                  retroversion_deg=28.0, side="right")
RIGID_GATES = dict(metric_ptp=0.5, point_ptp=1.0, normal_deg=0.5)
# phase 14b: tests/test_segmenter_ab.py's cohorts, and the margin by which
# the UNet arm may lose to the sphere arm on |max| error (deg, deg, mm)
AB_PER_COHORT = 4
AB_MARGIN = dict(ns=1.5, rv=2.0, rad=0.75)
# phase 14c: tests/test_ct_pitch_sweep.py's envelope of the CT-vs-mesh
# deltas per pitch (mm), and bench.py's gate against the JAX rows
PITCH_BOUNDS = {1.0: dict(rv=2.0, ns=1.0, rad=0.75),
                1.5: dict(rv=4.5, ns=2.0, rad=0.75)}
# tools/eval_ct_pitch.py's default pitches; 2.0 mm has no envelope (the
# JAX row calls the side wrong there) and is held to its row alone
PITCHES = (1.0, 1.5, 2.0)
PITCH_ISO_HU = 300.0
# phase 16: tools/eval_articular_torch.py's rows against the JAX
# package's (tools/eval_articular_rows_jax.json): each IoU within
# EVIDENCE_IOU, the plane, neck-shaft and radius errors of both segmenters
# within ACC_GATE (healthy) or ACC_ARTHRITIC_GATE (arthritic), the
# constructed neck-shaft equal; tools/eval_arthritic_ab_torch.py's arms:
# neck-shaft (deg) and qc_sphere_resid (mm) within AB_ROW_GATE of theirs
EVIDENCE_IOU = 0.01
AB_ROW_GATE = (0.3, 0.05)
# phase 14d: tests/test_arthritic_cohort.py's four variants (healthy first)
ROBUST_VARIANTS = (
    dict(),
    dict(head_flattening=0.2, surface_noise=0.4),
    dict(osteophyte_amp=3.0, surface_noise=0.3),
    dict(head_flattening=0.25, osteophyte_amp=2.0, surface_noise=0.5),
)
# host-ingest stages timed per call: (stage, module, function)
INGEST_STAGES = (
    ("read_weld_adjacency", "io.stl", "load_indexed"),
    ("weld_adjacency", "io.native", "weld_soup"),
    ("obb", "host.obb", "oriented_bounds"),
    ("obb_native_search", "io.native", "min_volume_box_silhouette"),
    ("head_detection", "io.ingest", "_head_end"),
    ("presort", "io.ingest", "_presort_faces"),
    ("spec", "io.ingest", "spec_from_arrays"),
)
NUMPY_ORACLE = (("io.stl", "load_indexed_numpy"), ("host.obb", "search_numpy"))


def log(msg):
    print(msg, flush=True)


def timed_cuda(fn, reps):
    """Mean ms per call of fn() over `reps` calls, by CUDA events.

    The card first spins for about 50 ms, so the host enqueues the calls
    while the queue is still busy: for a kernel whose wrapper takes longer
    on the host than the kernel takes on the card, the events then see
    the kernels back to back (device time), not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# The port's kernels that ran on the card since reset_launches(), counted
# by name from a profile of the card (bench.kernel_runs): a CUDA graph's
# replay (pipeline/graphs.py) calls no kernel wrapper, so the wrappers'
# launch counters see only the host's launches.  The first read ends the
# profile; later reads give the same counts until the next reset.
_RUNS = {"prof": None, "counts": dict.fromkeys(bench.LAUNCHES, 0)}


def reset_launches():
    """Zero the kernel runs and profile the card until the next read."""
    _end_runs()
    _RUNS["counts"] = dict.fromkeys(bench.LAUNCHES, 0)
    _start_runs()


def _start_runs():
    _RUNS["prof"] = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
    _RUNS["prof"].start()


def _end_runs():
    prof, _RUNS["prof"] = _RUNS["prof"], None
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
        for name, n in bench.kernel_runs(prof).items():
            _RUNS["counts"][name] += n


def _runs(names):
    _end_runs()
    return tuple(_RUNS["counts"][name] for name in names)


def launch_counts():
    """(slice-stack, raw-loop, standalone walk) kernel runs since
    reset_launches()."""
    return _runs(bench.LAUNCHES[:3])


def sphere_launch_counts():
    """(sphere score, sphere fit) kernel runs since reset_launches()."""
    return _runs(bench.LAUNCHES[3:])


def port_launches():
    """Every run of the port's own kernels since reset_launches()."""
    return sum(_runs(bench.LAUNCHES))


@contextlib.contextmanager
def counted_profiles():
    """Within the block a profile that bench.count_launches takes pauses
    the kernel runs' own, and its kernels are added to them (one
    profiler runs at a time)."""
    fn = bench.count_launches

    def wrapped(run):
        running = _RUNS["prof"] is not None
        _end_runs()
        out = fn(run)
        for name, n in bench.kernel_runs(out["prof"]).items():
            _RUNS["counts"][name] += n
        if running:
            _start_runs()
        return out

    with swapped(bench, "count_launches", wrapped):
        yield


def _kept(tree):
    """tree with each tensor cloned (a stage's result may live in a CUDA
    graph's pool, which its next replay overwrites); None while a graph
    is being captured, which runs nothing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return None
    return torch.utils._pytree.tree_map(
        lambda x: x.clone() if torch.is_tensor(x) else x, tree)


@contextlib.contextmanager
def recording(module, name, sink):
    """Within the block, module.name runs as usual and each call's
    (args, result), copied, is appended to sink.  A stage (a function
    that pipeline/graphs.py replays) shows each call; a function inside
    one shows only its stage's first call at a key, the eager run."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if (kept := _kept((args, out))) is not None:
            sink.append(kept)
        return out

    setattr(module, name, wrapped)
    try:
        yield sink
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def cuda_timing(module, name, sink):
    """Within the block, each call of module.name is bracketed by CUDA
    events and waited for, and (result, ms) is appended to sink."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn(*args, **kwargs)
        t1.record()
        t1.synchronize()
        sink.append((out, t0.elapsed_time(t1)))
        return out

    setattr(module, name, wrapped)
    try:
        yield sink
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def swapped(module, name, fn):
    """Within the block, module.name is fn.  A function inside a stage
    (pipeline/graphs.py) is called only where the stage runs eagerly: at
    its first call at a key, or under landmarks._stages."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def recording_raw(sink):
    """Within the block, slicing.slice_raw_banded runs as usual and each
    call's ((sg, z, band, max_chain, select, k), result) is appended to
    sink, band and k clamped as the wrapper clamps them."""
    from shoulder_tpu_torch.ops import slicing

    fn = slicing.slice_raw_banded
    sig = inspect.signature(fn)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bound_args = sig.bind(*args, **kwargs)
        bound_args.apply_defaults()
        sg, z, band, max_chain, select, k = bound_args.args
        band = min(band, sg.z_key.shape[-1])
        kept = _kept(((sg, z, band, max_chain, select, min(k, band)), out))
        if kept is not None:
            sink.append(kept)
        return out

    with swapped(slicing, "slice_raw_banded", wrapped):
        yield sink


def plain_raw_banded(sg, z, band, max_chain=2048, select="largest", k=512):
    """slice_raw_banded as the parent tree ran it on the card: the plain
    composition on CUDA tensors."""
    from shoulder_tpu_torch.ops import slicing

    band = min(band, sg.z_key.shape[-1])
    return slicing.slice_raw_banded_plain(sg, z, band, max_chain, select,
                                          min(k, band))


@contextlib.contextmanager
def ingest_split(sink):
    """Within the block, each call of a host-ingest stage (INGEST_STAGES)
    is timed into sink[stage] (seconds); at the end sink["native"] holds
    the rise of the native (ingest, OBB) counters and sink["numpy"] the
    calls of the numpy oracle, which the port's ingest never makes."""
    from shoulder_tpu_torch.io import native

    def module(name):
        return importlib.import_module(f"shoulder_tpu_torch.{name}")

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sink.setdefault(key, []).append(time.perf_counter() - t0)
        return wrapped

    numpy_calls = []

    def flagged(fn, key):
        def wrapped(*args, **kwargs):
            numpy_calls.append(key)
            return fn(*args, **kwargs)
        return wrapped

    patches = [(module(m), a, timed, key) for key, m, a in INGEST_STAGES]
    patches += [(module(m), a, flagged, a) for m, a in NUMPY_ORACLE]
    saved = [(mod, a, getattr(mod, a)) for mod, a, _, _ in patches]
    for mod, a, wrap, key in patches:
        setattr(mod, a, wrap(getattr(mod, a), key))
    before = (native.ingest_count, native.obb_count)
    try:
        yield sink
    finally:
        for mod, a, fn in saved:
            setattr(mod, a, fn)
        sink["native"] = (native.ingest_count - before[0],
                          native.obb_count - before[1])
        sink["numpy"] = len(numpy_calls)


def ingest_check(phase, sink, smi, n_specs=None):
    """Raise unless every BoneSpec of the phase (n_specs of them, where
    given) took one native OBB search, every mesh read from an STL or
    welded from a soup went native, and the numpy oracle never ran; log
    and return the ms per bone of each stage."""
    from shoulder_tpu_torch.io import native

    specs = len(sink.get("spec", []))
    meshes = (len(sink.get("read_weld_adjacency", []))
              + len(sink.get("weld_adjacency", [])))
    if (n_specs is not None and specs != n_specs) \
            or sink["native"] != (meshes, specs) or sink["numpy"]:
        raise AssertionError(
            f"{phase} ingest: {specs} specs (expected {n_specs}), native "
            f"(ingest, OBB) calls {sink['native']} for {meshes} meshes, "
            f"{sink['numpy']} numpy-oracle calls")
    ms = {key: 1e3 * sum(sink.get(key, [])) / specs
          for key, _, _ in INGEST_STAGES}
    ms["total"] = ms["read_weld_adjacency"] + ms["weld_adjacency"] + ms["spec"]
    log(f"{phase} ingest, ms per bone over {specs} bones: "
        + ", ".join(f"{key} {v:.2f}" for key, v in ms.items())
        + f"; native (ingest, OBB) calls {sink['native']}, numpy-oracle "
        f"calls 0 (host {native.host_cpu()}; {smi})")
    return {"bones": specs, "native_ingest": sink["native"][0],
            "native_obb": sink["native"][1], "numpy_calls": 0,
            "ms_per_bone": ms}


def bound(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move n_bytes and do n_ops operations at ops_per_s (float32 by
    default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def walk_work(succ, n_visits):
    """Bytes and operations of one walk over (R, K) rows: succ and crossed
    read once, order, is_start and n written once; about 4 integer
    operations per visited face."""
    rows, k = succ.shape
    return rows * k * (4 + 4 + 4 + 1) + rows * 4, 4 * n_visits


def stack_args(args):
    """(sg, zs, interp_num, band, k) of a recorded slice_stack call, with
    band and k clamped as slice_stack clamps them."""
    sg, zs, interp_num, band, compact_k = args[:5]
    band = min(band, sg.z_key.shape[-1])
    return sg, zs, interp_num, band, min(compact_k, band)


def searched_keys(z_key, zs):
    """Distinct z_key entries that binary searches of the planes read
    (searchsorted, side left): the least the window search needs, though
    the kernel's block-wide count reads more.  The top levels are the same
    keys for every plane, and count once."""
    keys, zs = z_key.cpu().numpy(), zs.cpu().numpy()
    a = np.zeros(zs.shape, np.int64)
    b = np.full(zs.shape, keys.shape[0], np.int64)
    seen = set()
    while (live := a < b).any():
        mid = (a + b) >> 1
        seen.update(mid[live].tolist())
        right = live & (keys[np.minimum(mid, keys.shape[0] - 1)] < zs)
        a = np.where(right, mid + 1, a)
        b = np.where(live & ~right, mid, b)
    return len(seen)


def slice_stack_work(sg, zs, interp_num, band, k):
    """Bytes and float operations the fused kernel needs for one stack,
    counted from these inputs: each z_mm row of the union of the planes'
    windows, each fvt/ids row of a kept crossed face, each z_key entry
    the binary searches touch and each cummax_z_max entry the overflow
    tests read (at lo - 1, lo > 0) read once, one z per plane; every
    output written once.  Operations: about 40 per kept face (segment,
    moments, arc length) and 20 per sample.  A batch's (zs (B, S)) is the
    sum of its bones' (each reads only its own faces)."""
    from shoulder_tpu_torch.ops import slicing

    if zs.dim() == 2:
        return tuple(map(sum, zip(*(
            slice_stack_work(slicing.SortedGeom(*(x[b] for x in sg)), zs[b],
                             interp_num, band, k)
            for b in range(zs.shape[0])))))
    n_faces, n_planes = sg.z_key.shape[0], zs.shape[0]
    los, _starts, _over = slicing._window_starts(sg, zs, band)
    cummax_read = int(torch.unique(los[los > 0]).numel())
    cover = np.zeros(n_faces + 1, np.int64)
    np.add.at(cover, los.cpu().numpy(), 1)
    np.add.at(cover, los.cpu().numpy() + band, -1)
    window_rows = int((np.cumsum(cover)[:n_faces] > 0).sum())
    idx = los[:, None] + torch.arange(band, device=zs.device)
    zmm = sg.z_mm[idx]
    crossed = (zmm[..., 1] >= zs[:, None]) & (zmm[..., 0] < zs[:, None])
    kept = crossed & (torch.cumsum(crossed, dim=1) <= k)
    gathered = int(torch.unique(idx[kept]).numel())
    reads = (window_rows * 8 + gathered * (9 * 4 + 4 * 4)
             + searched_keys(sg.z_key, zs) * 4 + cummax_read * 4
             + n_planes * 4)
    writes = n_planes * (interp_num * 8 + 8 + 4 + 4 + 1 + 1)
    ops = 40 * int(kept.sum()) + 20 * n_planes * interp_num
    return reads + writes, ops


def stack_disagreement(got, want):
    """Largest differences between two SliceStacks and the rows whose
    best loop differs (area or centroid beyond its tolerance); raises
    when the overflow or open-edge flags differ."""
    if not (torch.equal(got.overflow, want.overflow)
            and torch.equal(got.open_edges, want.open_edges)):
        raise AssertionError("overflow / open_edges differ")
    da = (got.areas - want.areas).abs()
    dc = (got.centroids - want.centroids).abs().amax(dim=-1)
    return {
        "contour_mm": float((got.contours - want.contours).abs().max()),
        "centroid_mm": float(dc.max()),
        "area_mm2": float(da.max()),
        "total_area_mm2": float((got.total_areas - want.total_areas).abs().max()),
        "rows": int(da.numel()),
        "loop_differs": int(((da > TOL_MM2) | (dc > TOL_MM)).sum()),
        "overflow_rows": int(want.overflow.sum()),
    }


def edge_planes(sg):
    """Planes above and below the bone, and planes at exact vertex
    heights (z_min of real faces)."""
    real = torch.isfinite(sg.z_mm[:, 0])
    z_lo, z_hi = float(sg.z_mm[real, 0].min()), float(sg.z_mm[real, 1].max())
    z_vert = sg.z_mm[real, 0]
    z_vert = z_vert[len(z_vert) // 9:: len(z_vert) // 9][:8]
    edge = torch.tensor([z_hi + 5.0, z_hi + 1e-3, z_lo - 1e-3, z_lo - 5.0],
                        device=z_vert.device)
    return torch.cat([edge, z_vert]).contiguous()


def walk_disagreement(kernel_out, plain_out):
    """Largest difference between two walks: n, is_start and order[:n]."""
    (o1, n1, s1), (o2, n2, s2) = kernel_out, plain_out
    valid = torch.arange(o1.shape[1], device=o1.device) < n1[:, None].long()
    err = [
        (n1.long() - n2.long()).abs().max(),
        torch.where(valid, (o1.long() - o2.long()).abs(), 0).max(),
        (valid & (s1 != s2)).long().max(),
    ]
    return int(max(e.item() for e in err)) if o1.numel() else 0


def random_walk_rows(rng, k, n_rows):
    """Rows of random disjoint loops over front-packed slots (the cases of
    tests/test_pallas_chain.py)."""
    succ = np.tile(np.arange(k, dtype=np.int32), (n_rows, 1))
    crossed = np.zeros((n_rows, k), np.int32)
    for r in range(n_rows):
        sizes = rng.integers(1, 40, size=rng.integers(1, 8)).tolist()
        while sum(sizes) > k - 4:
            sizes = sizes[:-1]
        perm = rng.permutation(sum(sizes))
        i = 0
        for sz in sizes:
            loop = perm[i:i + sz]
            succ[r, loop] = np.roll(loop, -1)
            i += sz
        crossed[r, :sum(sizes)] = 1
    return succ, crossed


def merging_walk_rows(rng, k, n_rows):
    """Successor rows of every kind the walk takes
    (tests/test_torch_cuda.py's): in even rows a random map (chains
    merge), in odd rows a random permutation (cycles); a tenth of the
    slots cut (its own successor, out of range, or negative); nc random."""
    slots = np.arange(k)
    succ = rng.integers(0, k, size=(n_rows, k))
    succ[1::2] = np.stack([rng.permutation(k) for _ in range(n_rows // 2)])
    u = rng.random((n_rows, k))
    succ = np.where(u < 0.04, slots, succ)
    succ = np.where((u >= 0.04) & (u < 0.07),
                    k + rng.integers(0, k, size=(n_rows, k)), succ)
    succ = np.where((u >= 0.07) & (u < 0.1),
                    -1 - rng.integers(0, 3, size=(n_rows, k)), succ)
    nc = rng.integers(0, k + 1, size=n_rows)
    return succ.astype(np.int32), (slots < nc[:, None]).astype(np.int32)


def gate_like(name, got, want):
    """side equal, neck-shaft / retroversion / radius within 0.05 of
    phase 4's values for the same bone (one card, one program)."""
    if got[0] != want[0]:
        raise AssertionError(f"{name}: side {got[0]}, phase 4 {want[0]}")
    for label, g, w in zip(("neck-shaft", "retroversion", "radius"),
                           got[1:], want[1:]):
        if not abs(g - w) < 0.05:
            raise AssertionError(f"{name}: {label} {g} vs phase 4 {w}")


def phase4_bone(lm_np, i):
    return ("left" if bool(lm_np.side_is_left[i]) else "right",
            float(lm_np.neckshaft[i]), float(lm_np.retroversion[i]),
            float(lm_np.radius_curvature[i]))


def facade_phase(td, path, dev, lm_np, smi):
    """Phase 7: the README flow through the public API on the card."""
    import shoulder_tpu_torch as stt
    from shoulder_tpu_torch.io import stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

    # (slice-stack, raw-loop) kernel runs of each step; walk runs of all
    counts = {}
    reset_launches()
    t0 = time.perf_counter()
    hum = stt.Humerus(path, device=dev)
    ingest_s = time.perf_counter() - t0
    hum.apply_csys_canal_transepiconylar()
    first_s = time.perf_counter() - t0
    runs = launch_counts()
    counts["landmarks"], walks = runs[:2], runs[2]
    log(f"facade: Humerus first landmark in {first_s * 1e3:.1f} ms wall "
        f"(ingest {ingest_s * 1e3:.1f} ms, landmarks and csys "
        f"{(first_s - ingest_s) * 1e3:.1f} ms), (slice-stack, raw-loop) "
        f"launches {counts['landmarks']} ({smi})")

    canal = hum.canal.axis()
    d = (canal[0] - canal[1]) / np.linalg.norm(canal[0] - canal[1])
    if not (np.allclose(np.abs(d), [0, 0, 1], atol=1e-4)
            and np.allclose(canal.mean(0), 0, atol=1e-3)):
        raise AssertionError(f"canal axis not on z through 0: {canal}")
    for name, arr in (("te", hum.trans_epiconylar.axis()),
                      ("groove", hum.bicipital_groove.axis()),
                      ("anp", hum.anatomic_neck.points())):
        if arr.ndim != 2 or arr.shape[1] != 3 or not np.isfinite(arr).all():
            raise AssertionError(f"facade {name}: shape {arr.shape}")
    got = (hum.side(), hum.neckshaft(), hum.retroversion(),
           hum.radius_curvature())
    log(f"facade bone 0: side {got[0]}, neck-shaft {got[1]:.3f}, "
        f"retroversion {got[2]:.3f}, radius {got[3]:.3f}")
    gate_like("facade", got, phase4_bone(lm_np, 0))

    # the osteotomy probes of the verify notes
    reset_launches()
    ost = stt.HumeralHeadOsteotomy(hum)
    if abs(ost.neckshaft_rel) > 1e-4 or abs(ost.retroversion_rel) > 1e-4:
        raise AssertionError("native cut is not at 0 / 0")
    ost.offest_neckshaft(5.0)
    if abs(ost.neckshaft_rel - 5.0) > 1e-4:
        raise AssertionError(f"neckshaft_rel {ost.neckshaft_rel} after +5")
    try:
        ost.offset_depth(1.0, "bogus")
    except ValueError:
        pass
    else:
        raise AssertionError("offset_depth accepted a bogus direction")
    head, rest = ost.resect_mesh()
    n_head, n_rest, n_all = len(head.faces), len(rest.faces), len(hum.mesh.faces)
    log(f"osteotomy: {n_all} faces -> head {n_head} + shaft {n_rest}")
    if not (n_head > 50 and n_rest > 50 and n_head + n_rest > n_all):
        raise AssertionError("resect_mesh split is implausible")
    if "mesh3d" not in stt.Plot(hum).figure.to_html():
        raise AssertionError("plot has no mesh3d trace")

    walks += launch_counts()[2]

    # the slice views: one slice-stack launch each
    reset_launches()
    for name in ("full_slices", "proximal_slices", "distal_slices"):
        view = getattr(hum, name)
        xy, areas = view.ixy((0.1, 0.9)), view.areas1((0.1, 0.9))
        log(f"view {name}: contours {xy.shape}, areas "
            f"{areas.min():.1f}..{areas.max():.1f} mm^2")
        if not (np.isfinite(xy).all() and (areas > 0).all()):
            raise AssertionError(f"{name}: non-finite contour or empty slice")
    runs = launch_counts()
    counts["views"] = runs[:2]
    walks += runs[2]

    # a proximal-only bone, on the card and on the CPU (plain composition)
    v, f = synthetic_humerus(side="left", proximal_only=True,
                             rng_transform=np.random.default_rng(8))
    prox_path = os.path.join(td, "proximal.stl")
    stl.write_stl(prox_path, v, f)
    reset_launches()
    ph = stt.ProximalHumerus(prox_path, device=dev)
    card = (ph.side(), ph.neckshaft(), ph.radius_curvature())
    runs = launch_counts()
    counts["proximal"] = runs[:2]
    walks += runs[2]
    ph_cpu = stt.ProximalHumerus(prox_path, device="cpu")
    cpu = (ph_cpu.side(), ph_cpu.neckshaft(), ph_cpu.radius_curvature())
    log(f"ProximalHumerus: card {card}, cpu {cpu}")
    if card[0] != "left" or cpu[0] != "left":
        raise AssertionError("ProximalHumerus got the side wrong")
    if not (abs(card[1] - cpu[1]) < 0.75 and abs(card[2] - cpu[2]) < 0.75):
        raise AssertionError("ProximalHumerus card and cpu differ")

    counts["walk"] = walks
    log(f"facade launches: {counts}")
    for name, want in (("landmarks", (3, 1)), ("views", (3, 0)),
                       ("proximal", (2, 1)), ("walk", 0)):
        if counts[name] != want:
            raise AssertionError(f"facade {name}: {counts[name]} launches, "
                                 f"expected {want}")
    return counts


def cohort_phase(paths, dev, lm_np, sides, smi, batch=4):
    """Phase 8: process_cohort over the STLs, ingest included; returns
    (slice-stack launches, the result dicts)."""
    from shoulder_tpu_torch import cohort

    reset_launches()
    t0 = time.perf_counter()
    res = cohort.process_cohort(paths, device=dev, batch_size=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    batches = -(-len(paths) // batch)
    want = (3 * batches, batches, 0)  # 3 slice-stack and 1 raw per batch
    log(f"cohort: {len(res)} bones in {wall:.2f} s, "
        f"{len(res) / wall:.3f} bones/s with ingest, batch {batch}, "
        f"(slice-stack, raw-loop, walk) launches {launches} ({smi})")
    if len(res) != len(paths):
        raise AssertionError("cohort lost bones")
    if launches != want:
        raise AssertionError(f"cohort: (slice-stack, raw-loop, walk) "
                             f"launches {launches}, expected {want}")
    for i, r in enumerate(res):
        got = (r["side"], r["neckshaft_deg"], r["retroversion_deg"],
               r["radius_curvature_mm"])
        if r["side"] != sides[i]:
            raise AssertionError(f"cohort bone {i}: side {r['side']}")
        gate_like(f"cohort bone {i}", got, phase4_bone(lm_np, i))
    summary = cohort.cohort_summary(res)
    log(f"cohort summary: {summary}")
    return launches, res


def walk_phase(dev, bone0_stacks, smi):
    """Phase 3: the standalone walk kernel against its plain version."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.ops import chain_walk, slicing

    k = min(DEFAULT_CONFIG.slice_compact_k, DEFAULT_CONFIG.proximal.band)
    rng = np.random.default_rng(0)
    cases = {"random": random_walk_rows(rng, k, 64),
             "merging": merging_walk_rows(rng, k, 256),
             "empty": (np.tile(np.arange(64, dtype=np.int32), (8, 1)),
                       np.zeros((8, 64), np.int32))}
    cases = {name: tuple(torch.as_tensor(a, device=dev) for a in c)
             for name, c in cases.items()}
    # the real rows: the plain compaction of bone 0's three stacks
    for name, (args, _) in zip(STACKS, bone0_stacks):
        sg, zs, _interp, band, kk = stack_args(args)
        crossed, _s, _e, succ, *_ = slicing.compact_stack(sg, zs, band, kk)
        cases[name] = (succ.reshape(-1, kk).to(torch.int32).contiguous(),
                       crossed.reshape(-1, kk).to(torch.int32).contiguous())
    max_err = 0
    for name, (succ, crossed) in cases.items():
        got = chain_walk.chain_walk_marked(succ, crossed)
        torch.cuda.synchronize()
        want = chain_walk.chain_walk_plain(succ, crossed)
        err = walk_disagreement(got, want)
        log(f"walk {name}: rows {succ.shape[0]} x {succ.shape[1]}, "
            f"visits {int(want[1].sum())}, max disagreement {err}")
        if err != 0:
            raise AssertionError(f"walk kernel disagrees on {name}")
        max_err = max(max_err, err)
    if int(chain_walk.chain_walk_marked(*cases["empty"])[1].max()) != 0:
        raise AssertionError("the empty slice visited faces")

    # the proximal stack (600 x 384) of one bone, and 8 bones' rows folded
    prox = cases["proximal"]
    prox8 = tuple(x.repeat(BATCH, 1).contiguous() for x in prox)
    visits = int(chain_walk.chain_walk_plain(*prox)[1].sum())
    res = {
        "ms": timed_cuda(lambda: chain_walk.chain_walk_marked(*prox), 50),
        "plain_ms": timed_cuda(lambda: chain_walk.chain_walk_plain(*prox), 3),
        "batch8_ms": timed_cuda(lambda: chain_walk.chain_walk_marked(*prox8),
                                50),
        "batch8_plain_ms": timed_cuda(
            lambda: chain_walk.chain_walk_plain(*prox8), 3),
    }
    res["bound_ms"], res["bound_by"] = bound(*walk_work(prox[0], visits))
    res["batch8_bound_ms"], _ = bound(*walk_work(prox8[0], BATCH * visits))
    log(f"walk time, proximal stack {tuple(prox[0].shape)}: kernel "
        f"{res['ms']:.4f} ms ({100 * res['bound_ms'] / res['ms']:.3g} % of "
        f"the bound), plain {res['plain_ms']:.2f} ms, bound "
        f"{res['bound_ms'] * 1e3:.3f} us ({smi})")
    log(f"walk time, batch-8 rows {tuple(prox8[0].shape)}: kernel "
        f"{res['batch8_ms']:.4f} ms "
        f"({100 * res['batch8_bound_ms'] / res['batch8_ms']:.3g} %), plain "
        f"{res['batch8_plain_ms']:.2f} ms, bound "
        f"{res['batch8_bound_ms'] * 1e3:.3f} us")
    res["max_abs_err"] = max_err
    return res


def check_stacks(cases):
    """Each (name, args, kernel result or None) case against the plain
    composition on the card, phase 5's tolerances; raises on a
    disagreement.  Returns the worst differences over the cases and the
    last case's."""
    from shoulder_tpu_torch.ops import slicing

    worst = {"contour_mm": 0.0, "centroid_mm": 0.0, "area_mm2": 0.0,
             "total_area_mm2": 0.0, "rows": 0, "loop_differs": 0}
    for name, args, got in cases:
        if got is None:
            got = slicing.slice_stack_kernel(*args)
        want = slicing.slice_stack_plain(*args)
        torch.cuda.synchronize()
        d = stack_disagreement(got, want)
        ok = (d["contour_mm"] <= TOL_MM and d["centroid_mm"] <= TOL_MM
              and d["area_mm2"] <= TOL_MM2 and d["total_area_mm2"] <= TOL_MM2)
        log(f"slice-stack {name}: {d}")
        if not ok:
            raise AssertionError(f"slice-stack kernel disagrees on {name}")
        for key in worst:
            worst[key] = (worst[key] + d[key] if key in ("rows",
                                                         "loop_differs")
                          else max(worst[key], d[key]))
    return worst, d


def fused_walk_check(cases):
    """The fused kernel's own walk (its timed build's walk output) on each
    (name, (sg, zs, interp_num, band, k)) case against the plain walk of
    the plain compaction's rows (the successors after the injectivity
    rule), exactly: n, and the face and the loop-start mark at every
    position below n, and -1 past n.  Raises on a disagreement; returns
    the rows compared and the largest disagreement (0)."""
    from shoulder_tpu_torch.ops import chain_walk, slicing

    total, worst = 0, 0
    for name, (sg, zs, interp_num, band, k) in cases:
        rows, dev = zs.numel(), zs.device
        walk, n = (torch.empty((rows, k), dtype=torch.int32, device=dev),
                   torch.empty((rows,), dtype=torch.int32, device=dev))
        slicing.slice_stack_kernel(sg, zs, interp_num, band, k,
                                   walk=(walk, n))
        crossed, _s, _e, succ, *_ = slicing.compact_stack(sg, zs, band, k)
        want = chain_walk.chain_walk_plain(
            succ.reshape(rows, k).to(torch.int32).contiguous(),
            crossed.reshape(rows, k).to(torch.int32).contiguous())
        err = walk_disagreement((torch.where(walk >= k, walk - k, walk), n,
                                 walk >= k), want)
        past = torch.arange(k, device=dev) >= n[:, None].long()
        tail = int((walk[past] != -1).sum())
        log(f"fused walk vs plain walk, {name}: rows {rows} x {k}, visits "
            f"{int(want[1].sum())}, disagreement {err}, entries past n "
            f"other than -1: {tail}")
        if err or tail:
            raise AssertionError(f"the fused kernel's walk differs from the "
                                 f"plain walk on {name}")
        total, worst = total + rows, max(worst, err, tail)
    return total, worst


def same_tensor(got, want):
    """Equal shapes and values, NaN equal to NaN."""
    if got.is_floating_point():
        return (torch.equal(got.isnan(), want.isnan())
                and torch.equal(got.nan_to_num(), want.nan_to_num()))
    return torch.equal(got, want)


def same_stack(got, want):
    """Every field of two SliceStacks (or Landmarks) equal."""
    return all(same_tensor(g, w) for g, w in zip(got, want))


def per_bone_launches(name, args, got):
    """Raise unless the batched launch `got` over zs (B, S) equals the
    kernel launched on each bone alone, bit for bit; returns B."""
    from shoulder_tpu_torch.ops import slicing

    sg, zs, interp_num, band, k = args
    for b in range(zs.shape[0]):
        one = slicing.slice_stack_kernel(
            slicing.SortedGeom(*(x[b] for x in sg)), zs[b], interp_num, band,
            k)
        if not same_stack(slicing.SliceStack(*(x[b] for x in got)), one):
            raise AssertionError(f"slice-stack {name}: bone {b} of the "
                                 f"batched launch differs from its own launch")
    torch.cuda.synchronize()
    return zs.shape[0]


def time_stack(name, args, smi, plain_too=True):
    """Kernel (and plain) times of one stack, its bound from these inputs,
    its shared memory and blocks per SM, and each stage's time inside a
    block."""
    from shoulder_tpu_torch.ops import kernels, slicing

    plain = slicing.slice_stack_plain
    a = stack_args(args)
    lib = kernels.library()
    bones = a[1].shape[0] if a[1].dim() == 2 else 1
    res = {"bones": bones, "planes": int(a[1].shape[-1]), "interp": a[2],
           "band": a[3], "k": a[4],
           "smem_bytes": int(lib.slice_stack_smem_bytes(a[3], a[4])),
           "blocks_per_sm": int(lib.slice_stack_blocks_per_sm(
               a[3], a[4], a[1].device.index or 0))}
    res["ms"] = timed_cuda(lambda: slicing.slice_stack_kernel(*a), 50)
    n_bytes, n_ops = slice_stack_work(*a)
    res["bytes"], res["ops"] = n_bytes, n_ops
    res["bound_ms"], res["bound_by"] = bound(n_bytes, n_ops)
    plain_txt = ""
    if plain_too:
        res["plain_ms"] = timed_cuda(lambda: plain(*a), 3)
        t0 = time.perf_counter()
        plain(*a)
        torch.cuda.synchronize()
        res["plain_wall_ms"] = (time.perf_counter() - t0) * 1e3
        plain_txt = (f", plain {res['plain_ms']:.2f} ms (host wall "
                     f"{res['plain_wall_ms']:.2f} ms)")
    log(f"slice-stack time, {name} stack {bones} x {res['planes']} x "
        f"{res['interp']} (band {res['band']}, k {res['k']}, "
        f"{res['smem_bytes']} B shared, {res['blocks_per_sm']} blocks per "
        f"SM): kernel {res['ms']:.4f} ms{plain_txt}, bound "
        f"{res['bound_ms'] * 1e3:.3f} us by {res['bound_by']} "
        f"({n_bytes} B), {100 * res['bound_ms'] / res['ms']:.3g} % of it "
        f"({smi})")
    res.update(stage_breakdown(
        lambda stamps: slicing.slice_stack_kernel(*a, stamps=stamps),
        a[1], slicing.STAGES))
    log(f"slice-stack stages, {name} stack, timed build "
        f"{res['timed_ms']:.4f} ms, SM clock {res['sm_ghz']:.3f} GHz, "
        f"block {res['block_us_median']:.2f} us (median); per stage, "
        f"us median / mean: " + ", ".join(
            f"{s} {res['stage_us_median'][s]:.2f} / "
            f"{res['stage_us_mean'][s]:.2f}" for s in res['stage_us_median']))
    return res


def slice_kernel_phase(main_stacks, bone0_stacks, smi):
    """Phase 5: each batched launch of the fused slice-stack kernel against
    its bones' own launches and the batched plain composition on the
    card; kernel and plain timed per stack of the batch, the kernel per
    stack of bone 0 alone."""
    cases = [(f"batch {name}", stack_args(args), out)
             for name, (args, out) in zip(STACKS, main_stacks)]
    n_bones = sum(per_bone_launches(*c) for c in cases)
    log(f"slice-stack: the {len(cases)} batched launches equal their "
        f"{n_bones} per-bone launches bit for bit")
    from shoulder_tpu_torch.ops import slicing

    sg0, _zs, interp0, band0, k0 = stack_args(bone0_stacks[1][0])
    sg0 = slicing.SortedGeom(*(x[0] for x in sg0))  # bone 0 alone: (F, ...)
    edge = edge_planes(sg0)
    cases.append(("bone 0 edge planes", (sg0, edge, interp0, band0, k0),
                  None))
    sgf, zsf, interpf, bandf, _k = stack_args(bone0_stacks[0][0])
    cases.append(("bone 0 full, k 64", (sgf, zsf, interpf, bandf, 64), None))
    worst, last = check_stacks(cases)
    if last["overflow_rows"] == 0:
        raise AssertionError("k = 64 did not overflow")
    worst["walk_rows"], worst["walk_err"] = fused_walk_check(
        [c[:2] for c in cases])
    log(f"slice-stack kernel vs plain, all {len(cases)} calls: {worst}")
    per_stack = {name: time_stack(f"batch {name}", args, smi)
                 for name, (args, _) in zip(STACKS, main_stacks)}
    per_stack_bone0 = {name: time_stack(f"bone 0 {name}", args, smi,
                                        plain_too=False)
                       for name, (args, _) in zip(STACKS, bone0_stacks)}
    return worst, per_stack, per_stack_bone0


def stage_breakdown(launch, zs, stages):
    """Each stage's time inside a block, from a kernel's timed build
    (clock64 at every stage boundary, converted by the blocks' own
    %globaltimer): `launch(stamps)` launches it over the planes `zs`, a
    block each, with `stages` (slicing.STAGES or RAW_STAGES).  The medians and means over
    the blocks of the last of 50 timed launches, the block total, the SM
    clock and the timed build's ms, which against the kernel's shows what
    the stamps cost."""
    from shoulder_tpu_torch.ops import slicing

    stamps = torch.zeros((zs.numel(), len(stages) + 3), dtype=torch.int64,
                         device=zs.device)
    timed_ms = timed_cuda(lambda: launch(stamps), 50)
    us, ghz = slicing.stage_times(stamps)
    return {"timed_ms": timed_ms, "sm_ghz": ghz,
            "block_us_median": float(us.sum(1).median()),
            "stage_us_median": dict(zip(stages, us.median(0).values.tolist())),
            "stage_us_mean": dict(zip(stages, us.mean(0).tolist()))}


def raw_stage_breakdown(name, args, smi, lib=None):
    """stage_breakdown of the raw-loop kernel on `args`, logged; `lib`:
    another build of the kernel (measurement only)."""
    from shoulder_tpu_torch.ops import slicing

    out = stage_breakdown(
        lambda stamps: slicing.slice_raw_kernel(*args, stamps=stamps,
                                                lib=lib),
        args[1], slicing.RAW_STAGES)
    log(f"raw-loop stages, {name}: block {out['block_us_median']:.2f} us at "
        f"{out['sm_ghz']:.3f} GHz (timed build {out['timed_ms']:.4f} ms): "
        + ", ".join(f"{key} {v:.2f}" for key, v in
                    out["stage_us_median"].items()) + f" us ({smi})")
    return out


def raw_work(sg, z, band, k, max_chain):
    """Bytes and float operations the raw-loop kernel needs for planes z
    (B,), one per bone, counted from these inputs: each bone's z_mm
    window, each fvt/ids row of a kept crossed face, the z_key entries a
    binary search reads and the cummax_z_max entry of the overflow test
    (at lo - 1, lo > 0) read once, z once; points, n, area, centroid and
    overflow written once.  Operations: about 40 per kept face (segment,
    sums)."""
    from shoulder_tpu_torch.ops import slicing

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


def raw_disagreement(got, want):
    """Largest differences between two (RawLoop, overflow) results, and
    the planes whose loop differs (n, or area or centroid beyond phase
    5's tolerances)."""
    (g, g_over), (w, w_over) = got, want
    da = (g.area - w.area).abs()
    dc = (g.centroid - w.centroid).abs().amax(dim=-1)
    return {
        "points_mm": float((g.points - w.points).abs().max()),
        "points_equal": bool(torch.equal(g.points, w.points)),
        "centroid_mm": float(dc.max()),
        "area_mm2": float(da.max()),
        "planes": int(da.numel()),
        "n_differs": int((g.n != w.n).sum()),
        "overflow_differs": int((g_over != w_over).sum()),
        "loop_differs": int(((g.n != w.n) | (da > TOL_MM2)
                             | (dc > TOL_MM)).sum()),
        "overflow_planes": int(w_over.sum()),
    }


def check_raw(cases):
    """Each (name, (sg, z, band, max_chain, select, k), kernel result or
    None) case against the plain composition on the card: n, overflow and
    the loop equal, points within 1e-5 mm; raises on a disagreement.
    Returns the worst differences over the cases and the last case's."""
    from shoulder_tpu_torch.ops import slicing

    worst = {"points_mm": 0.0, "centroid_mm": 0.0, "area_mm2": 0.0,
             "planes": 0, "loop_differs": 0, "points_equal": True}
    for name, args, got in cases:
        if got is None:
            got = slicing.slice_raw_kernel(*args)
        want = slicing.slice_raw_banded_plain(*args)
        torch.cuda.synchronize()
        d = raw_disagreement(got, want)
        log(f"raw loop {name} ({args[4]}, k {args[5]}): {d}")
        if (d["n_differs"] or d["overflow_differs"] or d["loop_differs"]
                or d["points_mm"] > 1e-5):
            raise AssertionError(f"raw-loop kernel disagrees on {name}")
        for key in worst:
            if key in ("planes", "loop_differs"):
                worst[key] += d[key]
            elif key == "points_equal":
                worst[key] = worst[key] and d[key]
            else:
                worst[key] = max(worst[key], d[key])
    return worst, d


def raw_per_bone(name, args, got):
    """Raise unless the batched raw-loop launch `got` over z (B,) equals
    the kernel launched on each bone alone, bit for bit; returns B."""
    from shoulder_tpu_torch.ops import slicing

    sg, z, *rest = args
    loop, over = got
    for b in range(z.shape[0]):
        one, one_over = slicing.slice_raw_kernel(
            slicing.SortedGeom(*(x[b:b + 1] for x in sg)), z[b:b + 1], *rest)
        if not (all(same_tensor(g[b:b + 1], w) for g, w in zip(loop, one))
                and same_tensor(over[b:b + 1], one_over)):
            raise AssertionError(f"raw loop {name}: bone {b} of the batched "
                                 f"launch differs from its own launch")
    torch.cuda.synchronize()
    return z.shape[0]


def time_raw(name, args, smi):
    """Kernel and plain times of one raw-loop call and its bound from
    these inputs."""
    from shoulder_tpu_torch.ops import kernels, slicing

    sg, z, band, max_chain, select, k = args
    res = {"bones": int(z.shape[0]), "band": band, "k": k,
           "max_chain": max_chain, "select": select,
           "smem_bytes": int(kernels.library().slice_raw_smem_bytes(
               band, k, max_chain))}
    res["ms"] = timed_cuda(lambda: slicing.slice_raw_kernel(*args), 50)
    res["plain_ms"] = timed_cuda(
        lambda: slicing.slice_raw_banded_plain(*args), 3)
    n_bytes, n_ops = raw_work(sg, z, band, k, max_chain)
    res["bytes"], res["ops"] = n_bytes, n_ops
    res["bound_ms"], res["bound_by"] = bound(n_bytes, n_ops)
    log(f"raw-loop time, {name}: {res['bones']} planes (band {band}, k {k},"
        f" max_chain {max_chain}, {res['smem_bytes']} B shared): kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.2f} ms, bound "
        f"{res['bound_ms'] * 1e3:.3f} us by {res['bound_by']} ({n_bytes} B), "
        f"{100 * res['bound_ms'] / res['ms']:.3g} % of it ({smi})")
    return res


def raw_loop_phase(main_raw, bone0_raw, smi):
    """Phase 5b: the raw-loop kernel against its plain version on the card
    (the main path's planes with both selects, bone 0's edge planes, the
    same planes at the CT shape, k 24) and the batched launch against its
    bones' own launches, at both shapes; kernel and plain timed, and each
    stage inside a block, on the main path's call and at the CT shape."""
    from shoulder_tpu_torch.ops import slicing

    args, out = main_raw
    sg, z, band, max_chain, select, k = args
    other = "largest" if select == "central" else "central"
    n_bones = raw_per_bone("batch neck planes", args, out)
    log(f"raw loop: the batched launch equals its {n_bones} per-bone "
        f"launches bit for bit")
    sg0 = slicing.SortedGeom(*(x[0] for x in bone0_raw[0][0]))
    edge = edge_planes(sg0)
    sge = slicing.SortedGeom(*(x[None].expand((edge.shape[0],) + x.shape)
                               .contiguous() for x in sg0))
    band0 = bone0_raw[0][2]
    # the CT sizes (phase 9's DENSE_CONFIG: band 6144, k 1024, max_chain 1024)
    # on the same planes: the kernel's block of 1024 threads
    ct_band = min(6144, sg.z_key.shape[-1])
    ct_args = (sg, z, ct_band, 1024, select, min(1024, ct_band))
    ct_name = "batch neck planes at the CT shape"
    ct_out = slicing.slice_raw_kernel(*ct_args)
    raw_per_bone(ct_name, ct_args, ct_out)
    log(f"raw loop: the batched launch at the CT shape equals its "
        f"{n_bones} per-bone launches bit for bit")
    cases = [("batch neck planes", args, out),
             ("batch neck planes", (sg, z, band, max_chain, other, k), None),
             ("bone 0 edge planes", (sge, edge, band0, max_chain, select, k),
              None),
             ("bone 0 edge planes", (sge, edge, band0, max_chain, other, k),
              None),
             (ct_name, ct_args, ct_out),
             (ct_name, ct_args[:4] + (other, ct_args[5]), None),
             ("bone 0 edge planes at the CT shape",
              (sge, edge, min(6144, sge.z_key.shape[-1]), 1024, select,
               min(1024, ct_band)), None),
             ("batch neck planes, k 24", (sg, z, band, max_chain, select,
                                          min(24, band)), None)]
    worst, last = check_raw(cases)
    if last["overflow_planes"] != z.shape[0]:
        raise AssertionError("k = 24 did not overflow every plane")
    log(f"raw-loop kernel vs plain, all {len(cases)} calls: {worst}")
    res = time_raw("batch neck planes", args, smi)
    res["stages"] = raw_stage_breakdown("batch neck planes", args, smi)
    res["ct_shape"] = time_raw(ct_name, ct_args, smi)
    res["ct_shape"]["stages"] = raw_stage_breakdown(ct_name, ct_args, smi)
    return worst, res


# phase 5c: the sphere kernels against their plain versions on the card:
# the scores of the hypotheses a pick may take (finite, radius in (10,
# 45) mm) within a relative SCORE_REL (below one point's weight, within
# SCORE_REL absolute), the pick the same or a tie (the top two plain
# scores within SCORE_REL relative), each fit's sphere and every bone's
# refined sphere within SPHERE_MM, each bone's mask on MASK_AGREE of its
# pixels
SCORE_REL = 1e-5
SPHERE_MM = 1e-3
MASK_AGREE = 0.999
SPHERE_CALLS = ("scores", "fit_moments", "irls_moments", "sigma_sums")


@contextlib.contextmanager
def recording_kw(module, name, sink):
    """Within the block, module.name runs as usual and each call's
    (args, kwargs, result), copied, is appended to sink (see recording)."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if (kept := _kept((args, kwargs, out))) is not None:
            sink.append(kept)
        return out

    setattr(module, name, wrapped)
    try:
        yield sink
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def plain_sphere():
    """Within the block, models/segment.sphere_segment takes the plain
    PyTorch versions of the sphere kernels on every device."""
    from shoulder_tpu_torch.ops import sphere

    plain = {"scores": sphere.score_plain, "fit_moments": sphere.moments_plain,
             "irls_moments": lambda pts, radius, center, scale, w_heur, heur:
             sphere.irls_moments_plain(pts, radius, center, scale, w_heur),
             "sigma_sums": sphere.sigma_sums_plain}
    with contextlib.ExitStack() as stack:
        for name, fn in plain.items():
            stack.enter_context(swapped(sphere, name, fn))
        yield


def sphere_launches(cfg):
    """(score, fit) kernel launches of one sphere_segment call under cfg:
    one score launch per pick (rounds A and B); two fit launches for each
    seed fit (the top rows, and the UNet's mask with the UNet segmenter)
    and each IRLS pass, one for each basin sigma (rounds A and the
    refined sphere)."""
    seeds = 2 if cfg.segmenter == "unet" else 1
    return 2, 2 * (seeds + cfg.sphere_seg_iters) + 2


def sphere_work(kind, n_bones, n_points, n_hyp=0, w_vectors=0):
    """(bytes, float32 operations) one call must move and do, each input
    read once and each output written once.  A (point, hypothesis) pair
    of the score takes 18 operations (difference, norm, residual, scale,
    the Tukey term, the row weight, the sum); a point of a fit 8 for the
    first pass's sums and 35 for the centred moments, and 16 more where
    its Tukey weight is made; the sigma's pass 20 a point.  `w_vectors`:
    the given weight vectors of P (1 where one vector serves every bone)."""
    pts = 12 * n_bones * n_points
    if kind == "score":
        n_bytes = (pts + 4 * n_points + 16 * n_bones * n_hyp + 4 * n_bones
                   + 4 * n_bones * n_hyp)
        return n_bytes, 18 * n_bones * n_hyp * n_points
    per_point = {"given": 8 + 35, "tukey": 16 + 8 + 35, "sigma": 20}[kind]
    outs = 4 * n_bones * (2 if kind == "sigma" else 3 + 20)
    ins = 4 * n_points * w_vectors if kind == "given" else 20 * n_bones
    return pts + ins + outs, per_point * n_bones * n_points


def rel_err(got, want, floor=1.0):
    """Largest |got - want| / max(|want|, floor) (0 over no values), NaN
    where want is NaN equal to NaN."""
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError("the kernel and the plain version disagree on "
                             "which values are NaN")
    if not got.numel():
        return 0.0
    d = (got.nan_to_num() - want.nan_to_num()).abs()
    return float((d / want.nan_to_num().abs().clamp(min=floor)).max())


def check_scores(calls):
    """Each recorded score call's kernel result against score_plain on the
    same inputs: the largest relative error over the hypotheses the pick
    may take (sphere.pickable), which must stay within SCORE_REL, and over
    the others, printed (a radius of thousands of mm puts float32 rounding
    of the distances, ~5e-4 mm, into both versions' residuals); both
    beside the same sums in float64; the picks compared (a different pick
    must be a tie of the plain scores)."""
    from shoulder_tpu_torch.ops import sphere

    worst, worst_abs, worst_other = 0.0, 0.0, 0.0
    picks, ties, f64 = 0, [], []
    for (pts, w_row, h_rad, h_cen, scale), _, got in calls:
        want = sphere.score_plain(pts, w_row, h_rad, h_cen, scale)
        ok = sphere.pickable(h_rad, h_cen)
        err = rel_err(got[ok], want[ok])
        worst = max(worst, err)
        worst_other = max(worst_other, rel_err(got[~ok], want[~ok]))
        worst_abs = max(worst_abs, float((got[ok] - want[ok]).abs().max()))
        # both against the same sums in float64, to tell whose rounding
        # a difference is
        exact = sphere.score_plain(
            pts.double(), w_row.double(), h_rad.double(), h_cen.double(),
            scale.double() if torch.is_tensor(scale) else scale)
        f64.append((rel_err(got[ok].double(), exact[ok]),
                    rel_err(want[ok].double(), exact[ok])))
        if err > SCORE_REL:
            d = torch.where(ok, (got - want).abs()
                            / want.abs().clamp(min=1.0), 0.0).nan_to_num()
            b, h = divmod(int(torch.argmax(d)), got.shape[-1])
            raise AssertionError(
                f"sphere scores off their plain version by {err:.3g} "
                f"relative (bone {b}, hypothesis {h} of radius "
                f"{float(h_rad[b, h])!r}: kernel {float(got[b, h])!r}, "
                f"plain {float(want[b, h])!r}, float64 "
                f"{float(exact[b, h])!r}); against float64, kernel / "
                f"plain: {f64}")
        k_pick = torch.argmax(torch.where(ok, got, -1.0), dim=-1)
        p_pick = torch.argmax(torch.where(ok, want, -1.0), dim=-1)
        picks += k_pick.numel()
        for b in torch.nonzero(k_pick != p_pick).flatten().tolist():
            top, other = (float(want[b, p_pick[b]]),
                          float(want[b, k_pick[b]]))
            if top - other > SCORE_REL * abs(top):
                raise AssertionError(
                    f"bone {b}: the score kernel picks hypothesis "
                    f"{int(k_pick[b])}, the plain version {int(p_pick[b])}, "
                    f"plain scores {top} / {other}: no tie")
            ties.append((b, int(k_pick[b]), int(p_pick[b]), top, other))
    return {"calls": len(calls), "max_rel_err": worst,
            "max_abs_err": worst_abs, "max_rel_err_unpickable": worst_other,
            "picks": picks, "ties": ties, "vs_float64": f64}


def check_fits(rec, eye4):
    """Each recorded fit, IRLS and sigma call's kernel result against its
    plain version on the same inputs, compared as the spheres (or sigmas)
    they give, in mm, and the moments' largest error relative to their
    matrix's largest entry.  Raises beyond SPHERE_MM."""
    from shoulder_tpu_torch.ops import sphere

    def sphere_err(got, want):
        (gr, gc), (wr, wc) = (sphere.solve(*got, eye4),
                              sphere.solve(*want, eye4))
        rel = float(((got[1] - want[1]).abs().amax(dim=(-2, -1))
                     / want[1].abs().amax(dim=(-2, -1))).max())
        return max(float((gr - wr).abs().max()),
                   float((gc - wc).abs().max())), rel

    res = {}
    for name in ("fit_moments", "irls_moments"):
        mm = rel = 0.0
        for args, _, got in rec[name]:
            want = (sphere.moments_plain(*args) if name == "fit_moments"
                    else sphere.irls_moments_plain(*args[:5]))
            e_mm, e_rel = sphere_err(got, want)
            mm, rel = max(mm, e_mm), max(rel, e_rel)
        res[name] = {"calls": len(rec[name]), "max_sphere_mm": mm,
                     "max_moment_rel": rel}
    mm = rel = 0.0
    for args, _, got in rec["sigma_sums"]:
        want = sphere.sigma_sums_plain(*args)

        def sigma(s):
            return torch.sqrt(s[1] / torch.clamp(s[0], min=1.0))
        mm = max(mm, float((sigma(got) - sigma(want)).abs().max()))
        rel = max(rel, rel_err(got[0], want[0]), rel_err(got[1], want[1],
                                                          floor=1e-6))
    res["sigma_sums"] = {"calls": len(rec["sigma_sums"]), "max_sigma_mm": mm,
                         "max_sum_rel": rel}
    worst = max(res["fit_moments"]["max_sphere_mm"],
                res["irls_moments"]["max_sphere_mm"],
                res["sigma_sums"]["max_sigma_mm"])
    if worst > SPHERE_MM:
        raise AssertionError(f"a sphere fit off its plain version by "
                             f"{worst:.3g} mm: {res}")
    return res


def sphere_kernels_per_bone(rec):
    """Raise unless every recorded batched call's kernel result equals the
    kernel's result on each bone alone, bit for bit; returns the launches
    compared."""
    from shoulder_tpu_torch.ops import sphere

    def one(x, b):
        return x[b:b + 1] if torch.is_tensor(x) and x.dim() else x

    n = 0
    for (pts, w_row, h_rad, h_cen, scale), _, got in rec["scores"]:
        for b in range(pts.shape[0]):
            alone = sphere.sphere_score_kernel(
                one(pts, b), w_row, one(h_rad, b), one(h_cen, b),
                one(scale, b))
            if not same_tensor(alone, got[b:b + 1]):
                raise AssertionError(f"sphere score: bone {b} alone differs "
                                     f"from its batch row")
            n += 1
    fits = [((pts,), dict(weights=sphere.GIVEN, w=w))
            for (pts, w), _, _ in rec["fit_moments"]]
    fits += [((pts,), dict(weights=sphere.TUKEY, radius=r.contiguous(),
                            center=c.contiguous(), scale=s))
             for (pts, r, c, s, _, _), _, _ in rec["irls_moments"]]
    fits += [((pts,), dict(weights=sphere.SIGMA, radius=r.contiguous(),
                            center=c.contiguous(), scale=s))
             for (pts, r, c, s), _, _ in rec["sigma_sums"]]
    for (pts,), kw in fits:
        batch = sphere.sphere_fit_kernel(pts, **kw)
        for b in range(pts.shape[0]):
            alone = sphere.sphere_fit_kernel(
                one(pts, b), **{k: one(v, b) for k, v in kw.items()})
            for g, w in zip(alone, batch):
                if g is not None and not same_tensor(g, w[b:b + 1]):
                    raise AssertionError(f"sphere fit ({kw['weights']}): "
                                         f"bone {b} alone differs from its "
                                         f"batch row")
            n += 1
    torch.cuda.synchronize()
    return n


def segment_agreement(got, want):
    """Per bone: mask agreement, |d radius|, max |d centre| (mm) and
    |d mean_resid| of two sphere_segment results."""
    mask = (got[0] == want[0]).float().mean(dim=(-2, -1))
    return {"mask_agree": mask.tolist(),
            "radius_mm": (got[1] - want[1]).abs().tolist(),
            "center_mm": (got[2] - want[2]).abs().amax(dim=-1).tolist(),
            "mean_resid_mm": (got[3] - want[3]).abs().tolist()}


def time_sphere(name, fn, plain, work, smi, library=None):
    """Kernel, plain and (where one PyTorch call computes the same)
    library times of one call, CUDA events, and its bound."""
    n_bytes, n_ops = work
    res = {"ms": timed_cuda(fn, 50), "plain_ms": timed_cuda(plain, 3),
           "library_ms": None if library is None else timed_cuda(library, 50),
           "bytes": n_bytes, "ops": n_ops}
    res["bound_ms"], res["bound_by"] = bound(n_bytes, n_ops)
    lib_txt = ("" if library is None
               else f", library {res['library_ms']:.4f} ms")
    log(f"sphere time, {name}: kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.3f} ms{lib_txt}, bound "
        f"{res['bound_ms'] * 1e3:.3f} us by {res['bound_by']} ({n_bytes} B, "
        f"{n_ops} ops), {100 * res['bound_ms'] / res['ms']:.3g} % of it "
        f"({smi})")
    return res


def time_sphere_kernels(rec, smi):
    """Phase 5c's times: the score kernel on round B's call and the fit
    kernel on the top-rows seed fit, the first IRLS pass and round A's
    sigma, for the batch and for bone 0 alone; plain versions beside them
    and, for the fit, torch.bmm of the same (A w)^T [A | f] product (its
    operands made beforehand; matmul TF32 off)."""
    from shoulder_tpu_torch.ops import sphere

    def one(x):
        return x[:1].contiguous() if torch.is_tensor(x) and x.dim() else x

    res = {}
    for tag, cut in (("batch", lambda x: x), ("bone0", one)):
        pts, w_row, h_rad, h_cen, scale = rec["scores"][-1][0]
        pts, h_rad, h_cen, scale = (cut(x) for x in (pts, h_rad, h_cen,
                                                      scale))
        n_bones, n_points = pts.shape[0], pts.shape[1]
        res[tag] = {"bones": n_bones, "points": n_points,
                    "hypotheses": h_rad.shape[-1]}
        res[tag]["score"] = time_sphere(
            f"score, {tag} ({n_bones} bones, {h_rad.shape[-1]} hypotheses)",
            lambda: sphere.sphere_score_kernel(pts, w_row, h_rad, h_cen,
                                               scale),
            lambda: sphere.score_plain(pts, w_row, h_rad, h_cen, scale),
            sphere_work("score", n_bones, n_points, h_rad.shape[-1]), smi)
        (_, w), _, _ = rec["fit_moments"][0]
        w = w[:n_bones]
        mean, _ = sphere.moments_plain(pts, w)
        q = pts - mean[..., None, :]
        a = torch.cat([2.0 * q, torch.ones_like(q[..., :1])], dim=-1)
        aw_t = (a * w[..., None]).transpose(-1, -2).contiguous()
        af = torch.cat([a, torch.sum(q**2, dim=-1, keepdim=True)], dim=-1)
        res[tag]["fit_given"] = time_sphere(
            f"fit, given weights (top rows), {tag}",
            lambda: sphere.sphere_fit_kernel(pts, sphere.GIVEN, w=w),
            lambda: sphere.moments_plain(pts, w),
            sphere_work("given", n_bones, n_points,
                        w_vectors=1 if w.stride(0) == 0 else n_bones), smi,
            library=lambda: torch.bmm(aw_t, af))
        args = [cut(x) for x in rec["irls_moments"][0][0][:5]]
        res[tag]["fit_irls"] = time_sphere(
            f"fit, one IRLS pass (Tukey weights made inside), {tag}",
            lambda: sphere.sphere_fit_kernel(
                args[0], sphere.TUKEY, radius=args[1], center=args[2],
                scale=args[3]),
            lambda: sphere.irls_moments_plain(*args),
            sphere_work("tukey", n_bones, n_points), smi,
            library=lambda: torch.bmm(aw_t, af))
        s_args = [cut(x) for x in rec["sigma_sums"][0][0]]
        res[tag]["sigma"] = time_sphere(
            f"basin sigma, {tag}",
            lambda: sphere.sphere_fit_kernel(
                s_args[0], sphere.SIGMA, radius=s_args[1], center=s_args[2],
                scale=s_args[3]),
            lambda: sphere.sigma_sums_plain(*s_args),
            sphere_work("sigma", n_bones, n_points), smi)
    return res


def sphere_phase(call, smi):
    """Phase 5c: the sphere kernels against their plain versions on the
    card, on phase 4's sphere_segment call (`call`: args, kwargs, result).
    Its rerun with every kernel call recorded equals phase 4's result bit
    for bit; each recorded call's kernel result against its plain version
    on the same inputs (scores within SCORE_REL and the same pick or a
    counted tie; each fit's sphere and sigma within SPHERE_MM); the whole
    call with the plain versions on the card against the kernels' (every
    bone's sphere within SPHERE_MM, its mask on MASK_AGREE of its pixels);
    each batched kernel call equal to its bones' own calls bit for bit,
    and each bone's sphere_segment alone against its batch row (printed,
    held to the same tolerances); then the times."""
    from shoulder_tpu_torch.models import segment
    from shoulder_tpu_torch.ops import sphere

    args, kwargs, got = call
    rec = {name: [] for name in SPHERE_CALLS}
    with contextlib.ExitStack() as stack:
        for name in SPHERE_CALLS:
            stack.enter_context(recording_kw(sphere, name, rec[name]))
        again = segment.sphere_segment(*args, **kwargs)
    torch.cuda.synchronize()
    if not same_stack(again, got):
        raise AssertionError("sphere_segment on the card is not "
                             "deterministic: its rerun differs")
    eye4 = torch.eye(4, device=got[1].device)
    res = {"scores": check_scores(rec["scores"]),
           "fits": check_fits(rec, eye4)}
    log(f"sphere kernels vs plain: scores {res['scores']}, fits "
        f"{res['fits']}")

    with plain_sphere():
        plain = segment.sphere_segment(*args, **kwargs)
    torch.cuda.synchronize()
    res["vs_plain"] = segment_agreement(got, plain)
    log(f"sphere_segment, kernels vs plain versions on the card: "
        f"{res['vs_plain']}")

    res["kernel_launches_compared"] = sphere_kernels_per_bone(rec)
    n_bones = got[1].shape[0]
    alone = []
    for b in range(n_bones):
        one = segment.sphere_segment(
            args[0][b:b + 1], *args[1:],
            **{k: (v[b:b + 1] if torch.is_tensor(v) else v)
               for k, v in kwargs.items()})
        alone.append(one)
    alone = tuple(torch.cat(x) for x in zip(*alone))
    res["bones_bit_equal_alone"] = sum(
        same_stack([x[b] for x in alone], [x[b] for x in got])
        for b in range(n_bones))
    res["alone_vs_batch"] = segment_agreement(alone, got)
    log(f"sphere kernels: every batched launch equals its bones' own "
        f"({res['kernel_launches_compared']} compared); sphere_segment bone "
        f"by bone alone: {res['bones_bit_equal_alone']} of {n_bones} bit for "
        f"bit their batch rows, {res['alone_vs_batch']}")
    for what in ("vs_plain", "alone_vs_batch"):
        agree = res[what]
        if (min(agree["mask_agree"]) < MASK_AGREE
                or max(agree["radius_mm"] + agree["center_mm"]) > SPHERE_MM):
            raise AssertionError(f"sphere_segment {what}: {agree}")
    res["time"] = time_sphere_kernels(rec, smi)
    return res


def welded_sizes(tris):
    """(vertices, faces, watertight) of a triangle soup after the weld."""
    from shoulder_tpu_torch.io import native

    verts, faces, _, watertight = native.weld_soup(tris)
    return verts.shape[0], faces.shape[0], watertight


def conv_ops(model, run):
    """(operations, result of run()): two per multiply-add of every
    Conv2d and Conv3d of `model` over one call of run()."""
    total = 0

    def count(mod, _inputs, out):
        nonlocal total
        total += 2 * out.numel() * mod.in_channels * int(
            np.prod(mod.kernel_size))

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    return total, result


def ct_phase(dev, rf, seg2d, smi, shape=CT_SHAPE, pitch=CT_PITCH,
             cfg=None):
    """Phase 9: the CT path, volumes -> 3D UNet -> marching tets -> weld
    -> one landmark batch, on the card."""
    from shoulder_tpu_torch.config import DENSE_CONFIG
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import ct_unet
    from shoulder_tpu_torch.ops import marching_tets, slicing
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import ct

    t_phase = time.perf_counter()
    cfg = cfg or DENSE_CONFIG
    n = len(CT_POSES)
    t0 = time.perf_counter()
    vols = [ct.synth_ct_volume(shape=shape, spacing=(pitch,) * 3, seed=1 + i,
                               noise_hu=15.0, side=side, retroversion_deg=rv,
                               neck_shaft_deg=ns, **CT_BONE_KW)
            for i, (side, rv, ns) in enumerate(CT_POSES)]
    log(f"ct: {n} volumes {shape} at {pitch} mm in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    # ---- per volume: UNet and marching tets on the card, weld and ingest
    # on the host
    specs, per_volume, seg0 = [], [], None
    for i, (vol, origin, spacing) in enumerate(vols):
        unet_calls, mt_calls, split = [], [], {}
        with cuda_timing(ct_unet, "apply_volume", unet_calls):
            seg, iso = ct.segment_volume(vol, "unet", device=dev)
        t0 = time.perf_counter()
        with cuda_timing(marching_tets, "marching_tets", mt_calls), \
                ingest_split(split):
            spec = ct.volume_to_spec(seg, origin, spacing, iso, config=cfg,
                                     max_tris=CT_MAX_TRIS, device=dev)
        spec_s = time.perf_counter() - t0
        ingest_ms = ingest_check(f"ct volume {i}", split, smi,
                                 n_specs=1)["ms_per_bone"]
        (soup, mt_ms), = mt_calls
        count = int(soup.count)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        soup.triangles[:count].cpu()
        e1.record()
        e1.synchronize()
        d2h_ms = e0.elapsed_time(e1)
        bone = seg > iso
        thr = torch.as_tensor(vol, device=seg.device) > 300.0
        iou = float((bone & thr).sum()) / float((bone | thr).sum())
        # marching tets reads the volume once and writes the triangles
        mt_bound_ms, _ = bound(seg.numel() * 4 + count * 36, 0)
        row = {"unet_ms": unet_calls[0][1], "marching_tets_ms": mt_ms,
               "marching_tets_bound_ms": mt_bound_ms, "d2h_ms": d2h_ms,
               "weld_ingest_s": spec_s - (mt_ms + d2h_ms) / 1e3,
               "ingest_ms": ingest_ms, "triangles": count, "faces": spec.n_faces,
               "verts": spec.n_verts, "iou": iou}
        per_volume.append(row)
        log(f"ct volume {i} ({CT_POSES[i][0]}): UNet {row['unet_ms']:.2f} ms, "
            f"marching tets {mt_ms:.2f} ms ({count} triangles, bound "
            f"{mt_bound_ms * 1e3:.2f} us by bytes), "
            f"device-to-host {d2h_ms:.2f} ms, weld + ingest "
            f"{row['weld_ingest_s']:.3f} s (host: weld + adjacency "
            f"{ingest_ms['weld_adjacency']:.1f} ms, OBB {ingest_ms['obb']:.1f}"
            f" ms, head detection {ingest_ms['head_detection']:.1f} ms, "
            f"presort {ingest_ms['presort']:.1f} ms), {spec.n_faces} faces / "
            f"{spec.n_verts} vertices, watertight {spec.watertight}, "
            f"IoU vs HU > 300 {iou:.4f} ({smi})")
        if not spec.watertight:
            raise AssertionError(f"ct volume {i}: the mesh is not watertight")
        if iou < CT_IOU:
            raise AssertionError(f"ct volume {i}: UNet IoU {iou:.4f}")
        specs.append(spec)
        if i == 0:
            seg0 = seg

    # ---- one landmark batch, counted
    bones = B.stack_bones(specs, dev)
    reset_launches()
    t0 = time.perf_counter()
    with recording(slicing, "slice_stack", []) as ct_stacks, \
            recording_raw([]) as ct_raw:
        lm = B.compute_landmarks_batch(bones, rf, cfg=cfg, seg_model=seg2d)
        torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches, raw_launches, walk_launches = launch_counts()
    log(f"ct batch of {n}: {batch_ms:.1f} ms wall, {launches} slice-stack "
        f"launches, {raw_launches} raw-loop launches, {walk_launches} walk "
        f"launches ({smi})")
    if (launches, raw_launches, walk_launches) != (3, 1, 0) \
            or len(ct_stacks) != 3 or len(ct_raw) != 1:
        raise AssertionError(f"ct batch: {launches} slice-stack, "
                             f"{raw_launches} raw-loop and {walk_launches} "
                             f"walk launches, expected 3, 1 and 0")
    lm_ct = B.landmarks_to_numpy(lm)

    # ---- the direct mesh of each generator bone, same config
    direct = []
    for side, rv, ns in CT_POSES:
        v, f = synthetic_humerus(n_rings=220, n_theta=192, side=side,
                                 retroversion_deg=rv, neck_shaft_deg=ns,
                                 **CT_BONE_KW)
        nb, wt = stl.edge_face_adjacency(f)
        direct.append(ingest.spec_from_arrays("direct_mesh", v, f, nb, wt,
                                              config=cfg))
    lm_mesh = B.landmarks_to_numpy(B.compute_landmarks_batch(
        B.stack_bones(direct, dev), rf, cfg=cfg, seg_model=seg2d))
    for i, (side, _rv, _ns) in enumerate(CT_POSES):
        got = {name: float(getattr(lm_ct, name)[i]) for name, _ in CT_GATES}
        want = {name: float(getattr(lm_mesh, name)[i]) for name, _ in CT_GATES}
        log(f"ct bone {i} ({side}): " + ", ".join(
            f"{name} {got[name]:.3f} (mesh {want[name]:.3f})"
            for name, _ in CT_GATES)
            + f", side left {bool(lm_ct.side_is_left[i])} (mesh "
            f"{bool(lm_mesh.side_is_left[i])}), overflow "
            f"{bool(lm_ct.qc_slice_overflow[i])} (mesh "
            f"{bool(lm_mesh.qc_slice_overflow[i])})")
        if (bool(lm_ct.side_is_left[i]) != (side == "left")
                or bool(lm_mesh.side_is_left[i]) != (side == "left")):
            raise AssertionError(f"ct bone {i}: side differs")
        if lm_ct.qc_slice_overflow[i] or lm_mesh.qc_slice_overflow[i]:
            raise AssertionError(f"ct bone {i}: slice overflow")
        for name, tol in CT_GATES:
            if not abs(got[name] - want[name]) < tol:
                raise AssertionError(f"ct bone {i}: {name} {got[name]} vs "
                                     f"direct mesh {want[name]}")

    # ---- card vs CPU: marching tets on volume 0's threshold surface, and
    # the UNet on volume 0
    vol, origin, spacing = vols[0]
    args = (300.0, tuple(map(float, origin)), tuple(map(float, spacing)))
    card = marching_tets.marching_tets(torch.as_tensor(vol, device=dev),
                                       *args, max_tris=CT_MAX_TRIS)
    cpu = marching_tets.marching_tets(torch.as_tensor(vol), *args,
                                      max_tris=CT_MAX_TRIS)
    count = int(cpu.count)
    mt_err = float((card.triangles.cpu() - cpu.triangles).abs().max())
    w_card = welded_sizes(card.triangles[:count].cpu().numpy())
    w_cpu = welded_sizes(cpu.triangles[:count].numpy())
    log(f"ct marching tets, card vs cpu on volume 0 at HU 300: count "
        f"{int(card.count)} / {count}, max |triangle| {mt_err:.3g} mm, weld "
        f"(vertices, faces, watertight) {w_card} / {w_cpu}")
    if int(card.count) != count or mt_err > 1e-4 or w_card != w_cpu:
        raise AssertionError("ct: marching tets differ between card and cpu")
    model = ct_unet.load_model("cpu")
    unet_ops, (seg_cpu, _) = conv_ops(
        model, lambda: ct.segment_volume(vol, "unet", device="cpu"))
    agree = float(((seg0.cpu() > 0) == (seg_cpu > 0)).double().mean())
    log(f"ct UNet, card vs cpu on volume 0: mask agreement {agree:.6f}, max "
        f"|logit| difference {float((seg0.cpu() - seg_cpu).abs().max()):.3g}")
    if agree < 0.999:
        raise AssertionError(f"ct: UNet masks agree on {agree:.6f} only")
    # the UNet reads the volume and its weights once and writes the logits;
    # its convolutions are bf16 tensor-core work
    unet_bytes = 2 * seg_cpu.numel() * 4 + sum(
        t.numel() * t.element_size() for t in model.parameters())
    unet_bound_ms, unet_bound_by = bound(unet_bytes, unet_ops, BF16_OPS_PER_S)
    warm = [row["unet_ms"] for row in per_volume[1:]]
    log(f"ct UNet work: {unet_ops / 1e9:.2f} GFLOP of convolutions, "
        f"{unet_bytes} B; bound {unet_bound_ms:.4f} ms by {unet_bound_by}; "
        f"warm calls {min(warm):.2f}-{max(warm):.2f} ms ({smi})")

    # ---- each batched CT launch against its bones' own launches and the
    # batched plain composition
    cases = [(f"ct batch {name}", stack_args(a), out)
             for name, (a, out) in zip(STACKS, ct_stacks)]
    n_bones = sum(per_bone_launches(*c) for c in cases)
    log(f"slice-stack: the {len(cases)} batched ct launches equal their "
        f"{n_bones} per-bone launches bit for bit")
    worst, _ = check_stacks(cases)
    worst["walk_rows"], worst["walk_err"] = fused_walk_check(
        [c[:2] for c in cases])
    log(f"slice-stack kernel vs plain, all {len(ct_stacks)} batched ct "
        f"stacks: {worst}")
    per_stack = {name: time_stack(f"ct batch {name}", a, smi)
                 for name, (a, _) in zip(STACKS, ct_stacks)}
    # ---- the batched raw-loop launch at the CT sizes
    (raw_args, raw_out), = ct_raw
    raw_per_bone("ct neck planes", raw_args, raw_out)
    raw_worst, _ = check_raw([("ct neck planes", raw_args, raw_out)])
    raw_time = time_raw("ct neck planes", raw_args, smi)
    raw_time["stages"] = raw_stage_breakdown("ct neck planes", raw_args, smi)
    total_s = time.perf_counter() - t_phase
    log(f"ct phase: {total_s:.1f} s in all ({smi})")
    ingest = {key: float(np.mean([row["ingest_ms"][key] for row in
                                  per_volume]))
              for key in per_volume[0]["ingest_ms"]}
    return {"launches": launches, "raw_launches": raw_launches,
            "raw_worst": raw_worst, "raw_time": raw_time,
            "worst": worst, "per_stack": per_stack,
            "per_volume": per_volume, "batch_ms": batch_ms,
            "ingest": {"bones": n, "native_ingest": n, "native_obb": n,
                       "numpy_calls": 0, "ms_per_bone": ingest},
            "unet_gflop": unet_ops / 1e9, "unet_bound_ms": unet_bound_ms,
            "unet_bound_by": unet_bound_by, "total_s": total_s}


def tool_json(name):
    """tools/<name> beside this script, parsed."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name)
    with open(path) as fh:
        return json.load(fh)


def load_tool(name):
    """tools/<name>.py beside this script, as a module."""
    return load_script(os.path.join("tools", f"{name}.py"))


def load_script(rel):
    """The Python file at `rel` under this script's directory, as a
    module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_grads(model_from_flat, flat, loss_fn, images, labels, device,
               compute_dtype=torch.bfloat16):
    """(loss, {name: gradient on the host}) of one forward and backward
    from the flat weights `flat` on `device`."""
    model = model_from_flat(flat, compute_dtype, serving=False).to(device)
    loss = loss_fn(model, images.to(device), labels.to(device))
    loss.backward()
    return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}


def time_steps(model, optimizer, loss_fn, images, labels, smi, name):
    """ms per optimiser step on a fixed batch (CUDA events, 10 warm
    steps), the peak memory of those steps, and their bound: forward and
    backward convolution operations (three times the forward count) over
    the bf16 tensor-core rate."""
    from shoulder_tpu_torch.models import unet_train

    def step():
        return unet_train.train_step(model, optimizer, loss_fn, images, labels)

    fwd_ops, _ = conv_ops(model, lambda: loss_fn(model, images, labels))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = timed_cuda(step, 10)
    peak = torch.cuda.max_memory_allocated()
    n_bytes = 2 * images.numel() * 4 + 3 * sum(
        p.numel() * 4 for p in model.parameters())
    bound_ms, bound_by = bound(n_bytes, 3 * fwd_ops, BF16_OPS_PER_S)
    log(f"train {name}: {ms:.2f} ms per step on {tuple(images.shape)} "
        f"(forward, backward, AdamW), peak memory {peak / 2**20:.1f} MiB, "
        f"{3 * fwd_ops / 1e9:.2f} GFLOP of convolutions forward and "
        f"backward, bound {bound_ms:.4f} ms by {bound_by}, "
        f"{100 * bound_ms / ms:.3g} % of it ({smi})")
    return {"ms": ms, "peak_bytes": peak, "gflop": 3 * fwd_ops / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by}


def train_phase(td, dev, rf, bone0, bone0_image, lm_bone0, smi, n_corpus=8,
                steps=30, batch=16, ct_steps=10, ct_size=(64, 48, 48),
                cfg=None):
    """Phase 10: corpus, both trainers, checkpoints and serving from them,
    on the card.  `lm_bone0`: bone 0's landmarks from its own run in phase
    4 (a batch of one, as the zero-step check below runs it), as numpy."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.models import convert, ct_unet, unet, unet_train
    from shoulder_tpu_torch.ops import slicing
    from shoulder_tpu_torch.pipeline import ct
    from shoulder_tpu_torch.pipeline import landmarks as L

    t_phase = time.perf_counter()
    cfg = cfg or DEFAULT_CONFIG
    log(f"train: cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # ---- corpus: every extraction timed and counted
    tool = load_tool("make_unet_corpus_torch")
    reset_launches()
    t0 = time.perf_counter()
    split = {}
    with recording(slicing, "slice_stack", []) as stacks, \
            cuda_timing(tool, "extract_one", []) as extractions, \
            ingest_split(split):
        images, masks = tool.build_corpus(n_corpus, 0, config=cfg, device=dev)
    corpus_s = time.perf_counter() - t0
    ingest = ingest_check("corpus", split, smi)
    launches, raw_launches, walk_launches = launch_counts()
    n_extracted = len(extractions)
    extract_s = sum(ms for _, ms in extractions) / 1e3 / n_extracted
    log(f"corpus: {images.shape[0]} pairs {images.shape[1:]} from "
        f"{n_extracted} bones in {corpus_s:.1f} s; extraction "
        f"{extract_s:.3f} s per bone (first {extractions[0][1]:.0f} ms, "
        f"ingest apart), host ingest and the rest "
        f"{(corpus_s - extract_s * n_extracted) / n_extracted:.2f} s per "
        f"bone; {launches} slice-stack launches, {raw_launches} raw-loop "
        f"launches, {walk_launches} walk launches ({smi})")
    if ingest["bones"] < n_extracted:
        raise AssertionError(f"corpus: {ingest['bones']} specs for "
                             f"{n_extracted} extracted bones")
    if launches != 2 * n_extracted or len(stacks) != launches \
            or raw_launches != 0 or walk_launches != 0:
        raise AssertionError(f"corpus: {launches} slice-stack, "
                             f"{raw_launches} raw-loop and "
                             f"{walk_launches} walk launches for "
                             f"{n_extracted} bones, expected "
                             f"{2 * n_extracted} and 0")
    fracs = masks.reshape(masks.shape[0], -1).mean(axis=1)
    log("corpus mask fractions: " + ", ".join(f"{f:.3f}" for f in fracs))
    if images.shape != (n_corpus,) + tuple(bone0_image.shape) \
            or not np.isfinite(images).all() \
            or not ((fracs > 0.05) & (fracs < 0.95)).all():
        raise AssertionError("corpus: a kept pair is degenerate")
    worst, _ = check_stacks(
        [(f"corpus bone 0 {name}", stack_args(args), out)
         for name, (args, out) in zip(STACKS[:2], stacks[:2])])
    del stacks

    # ---- articular UNet: (a) from random weights on the corpus
    size = images.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with cuda_timing(unet_train, "train_step", []) as step_ms, \
            cuda_timing(unet_train, "mixture_batch", []) as batch_ms:
        model, losses = unet_train.train_mixture(
            images, masks, steps=steps, batch=batch, size=size, log_every=1,
            device=dev, generator=gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_ms, batch_ms = ([ms for _, ms in sink] for sink in (step_ms, batch_ms))
    log(f"train unet: {steps} steps of batch {batch} from random weights, "
        f"{wall_ms:.1f} ms wall per step with the batch's synthesis and "
        f"the loss read back (the step itself: first {step_ms[0]:.0f} ms, "
        f"median of the rest {np.median(step_ms[1:]):.1f} ms; the batch: "
        f"first {batch_ms[0]:.0f} ms, median of the rest "
        f"{np.median(batch_ms[1:]):.1f} ms); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, mean of the first five {first:.4f}, of the "
        f"last five {last:.4f}")
    if len(losses) != steps or not np.isfinite(losses).all() \
            or not last < first:
        raise AssertionError("train unet: the loss did not fall")

    # ---- (b) one step from the shipped weights, card against CPU
    corpus_dev = tuple(torch.as_tensor(a).to(dev, torch.float16)
                       for a in (images, masks))
    n_proc, n_corp = unet_train.mixture_counts(batch, 0.25)
    fixed = unet_train.mixture_batch(gen, *corpus_dev, n_corp, n_proc, size)
    shipped = unet_train.load_params()
    fresh = convert.unet_flat_params(
        unet_train.new_model(torch.Generator().manual_seed(1)).state_dict())
    t0 = time.perf_counter()
    worst_rel, shipped_f32 = {}, None
    for name, flat, dtype in (("random weights, bf16", fresh, torch.bfloat16),
                              ("shipped weights, float32", shipped,
                               torch.float32),
                              ("shipped weights, bf16", shipped,
                               torch.bfloat16)):
        args = (unet.model_from_flat, flat, unet_train.dice_bce_loss, *fixed)
        loss_card, g_card = step_grads(*args, dev, dtype)
        loss_cpu, g_cpu = step_grads(*args, "cpu", dtype)
        rel = {n: float((g_card[n] - g_cpu[n]).norm() / g_cpu[n].norm())
               for n in g_cpu}
        x, y = (torch.cat([g[n].flatten() for n in g_cpu]).double()
                for g in (g_card, g_cpu))
        worst_rel[name] = max(rel.values())
        log(f"train unet, one step from {name}, card vs cpu: loss "
            f"{loss_card:.6f} / {loss_cpu:.6f}; gradient relative L2, "
            f"largest over the {len(rel)} parameters "
            f"{worst_rel[name]:.3g} ({max(rel, key=rel.get)}), whole "
            f"gradient {float((x - y).norm() / y.norm()):.3g}, cosine "
            f"{float(x @ y / x.norm() / y.norm()):.6f}")
        if not abs(loss_card - loss_cpu) <= 2e-2 * abs(loss_cpu):
            raise AssertionError(f"train unet ({name}): card and cpu losses "
                                 f"differ")
        # at the shipped weights the gradient is a small residual of sums
        # that cancel, so bf16 rounding moves it far from float32; the
        # card's bf16 gradient is held to the CPU's, and its distance from
        # its float32 one to the CPU's (both were 6x apart while cuDNN's
        # convolutions rounded twice, ROADMAP fault 5)
        if name == "shipped weights, float32":
            shipped_f32 = (x, y)
        elif name == "shipped weights, bf16":
            off_card, off_cpu = (float((g - g32).norm() / g32.norm())
                                 for g, g32 in zip((x, y), shipped_f32))
            cos_card, cos_cpu = (float(g @ g32 / g.norm() / g32.norm())
                                 for g, g32 in zip((x, y), shipped_f32))
            worst_rel["shipped weights, bf16 vs float32 on the card"] = off_card
            worst_rel["shipped weights, bf16 vs float32 on the cpu"] = off_cpu
            log(f"train unet, shipped weights, whole gradient in bf16 against "
                f"the same device's in float32: relative L2 card "
                f"{off_card:.3g}, cpu {off_cpu:.3g}; cosine card "
                f"{cos_card:.4f}, cpu {cos_cpu:.4f}")
            if not off_card <= 1.25 * off_cpu:
                raise AssertionError("train unet: the card's bf16 gradient at "
                                     "the shipped weights lies farther from "
                                     "its float32 one than the CPU's")
        if worst_rel[name] > 5e-2:
            raise AssertionError(f"train unet ({name}): the gradient of "
                                 f"{max(rel, key=rel.get)} differs by "
                                 f"{worst_rel[name]:.3g}")
    log(f"train unet: the three cpu steps and the card's took "
        f"{time.perf_counter() - t0:.1f} s")
    timed_model = unet.model_from_flat(shipped, serving=False).to(dev)
    unet_step = time_steps(timed_model, unet_train.adamw(timed_model, 3e-4),
                           unet_train.dice_bce_loss, *fixed, smi, "unet")
    del timed_model, g_card, g_cpu, corpus_dev, fixed

    # ---- (c) checkpoints: save, load, serve
    path = os.path.join(td, "unet_trained.npz")
    unet_train.save_params(model, path)
    served = unet.load_model(dev, path)
    mask = unet.segment_image(served, bone0_image)
    want = unet.segment_image(unet.serving_(copy.deepcopy(model)), bone0_image)
    log(f"serve unet: trained mask on phase 4's bone 0 image covers "
        f"{float(mask.mean()):.4f}, equal to the in-memory model's: "
        f"{torch.equal(mask, want)}")
    if not torch.equal(mask, want):
        raise AssertionError("serve unet: the saved model's mask differs")
    zero = os.path.join(td, "unet_zero_step.npz")
    unet_train.save_params(unet.model_from_flat(shipped, serving=False), zero)
    lm0 = L.compute_landmarks(bone0, rf, cfg=cfg,
                              seg_model=unet.load_model(dev, zero))
    for name in ("neckshaft", "retroversion", "radius_curvature"):
        got, ref = float(getattr(lm0, name)), float(getattr(lm_bone0, name))
        log(f"serve unet, zero-step save: {name} {got!r} (phase 4, bone 0 "
            f"alone {ref!r})")
        if got != ref:
            raise AssertionError(f"serve unet: {name} differs from phase 4")
    if bool(lm0.side_is_left) != bool(lm_bone0.side_is_left):
        raise AssertionError("serve unet: side differs from phase 4")

    # ---- CT UNet: from the shipped weights, then from random ones
    ct_losses = {}
    for name, init in (("shipped", ct_unet.load_params()), ("random", None)):
        t0 = time.perf_counter()
        ct_model, ct_losses[name] = ct_unet.train(
            steps=ct_steps, size=ct_size, log_every=1, init_params=init,
            device=dev)
        torch.cuda.synchronize()
        log(f"train ct_unet from {name} weights: {ct_steps} steps at "
            f"{ct_size}, {(time.perf_counter() - t0) * 1e3 / ct_steps:.1f} "
            f"ms wall per step with the volume's synthesis on the host; "
            f"loss {ct_losses[name][0]:.4f} -> {ct_losses[name][-1]:.4f}")
        if len(ct_losses[name]) != ct_steps \
                or not np.isfinite(ct_losses[name]).all():
            raise AssertionError(f"train ct_unet ({name}): bad losses")
    if not ct_losses["random"][-1] < ct_losses["random"][0]:
        raise AssertionError("train ct_unet: the loss did not fall")
    vol, _, _ = ct.synth_ct_volume(shape=ct_size,
                                   spacing=(300.0 / ct_size[0], 1.8, 1.8))
    vol = torch.as_tensor(vol, device=dev)
    ct_step = time_steps(
        ct_model, unet_train.adamw(ct_model, 1e-3), unet_train.bce_loss,
        vol[None, None] / ct_unet.HU_SCALE,
        (vol > 350.0).to(torch.float32)[None, None], smi, "ct_unet")
    ct_path = os.path.join(td, "ct_unet_trained.npz")
    ct_unet.save_params(ct_model, ct_path)
    logits = ct_unet.apply_volume(ct_unet.load_model(dev, ct_path), vol)
    ct_want = ct_unet.apply_volume(unet.serving_(copy.deepcopy(ct_model)), vol)
    if logits.shape != vol.shape or not torch.isfinite(logits).all() \
            or not torch.equal(logits, ct_want):
        raise AssertionError("serve ct_unet: the saved model's logits differ")
    log(f"serve ct_unet: logits of the saved model equal the in-memory "
        f"model's, bone fraction {float((logits > 0).float().mean()):.4f}")
    total_s = time.perf_counter() - t_phase
    log(f"training phase: {total_s:.1f} s in all ({smi})")
    return {"launches": launches, "worst": worst, "bones": n_extracted,
            "extract_s_per_bone": extract_s, "unet_step": unet_step,
            "ct_unet_step": ct_step, "unet_losses": losses,
            "card_vs_cpu_gradient": worst_rel, "ingest": ingest,
            "ct_losses": ct_losses, "total_s": total_s}


def accuracy_cohort(rng, arthritic, n=ACC_PER_COHORT):
    """tests/test_accuracy_gate.py's cohort of n BoneSpecs and truths from
    `rng` (healthy first, then arthritic, one stream), through the port's
    spec_from_arrays: tools/eval_accuracy_torch.py's make_cohort, the twin
    of tools/eval_accuracy.py's; with n = AB_PER_COHORT and
    default_rng(77), tests/test_segmenter_ab.py's."""
    return load_tool("eval_accuracy_torch").make_cohort(n, rng, arthritic)


def accuracy_phase(dev, rf, seg2d, smi):
    """Phase 11: the accuracy cohorts on the card, against the truth, the
    accuracy gate's BOUNDS and the JAX package's committed rows.  Each
    cohort's result keeps its BoneSpecs and truths for phase 14 and its
    landmarks (`lm`) for phase 16."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.pipeline import batch as B

    t_phase = time.perf_counter()
    jax_rows = tool_json("eval_accuracy_results.json")
    rng = np.random.default_rng(2026)
    out = {}
    for name in ("healthy", "arthritic"):
        split = {}
        t0 = time.perf_counter()
        with ingest_split(split):
            specs, truth = accuracy_cohort(rng, name == "arthritic")
        ingest_s = time.perf_counter() - t0
        ingest = ingest_check(f"accuracy {name}", split, smi)
        t0 = time.perf_counter()
        lm = B.landmarks_to_numpy(B.compute_landmarks_batch(
            B.stack_bones(specs, dev), rf, cfg=DEFAULT_CONFIG,
            seg_model=seg2d))
        batch_s = time.perf_counter() - t0
        got = np.stack([lm.neckshaft, lm.retroversion, lm.radius_curvature],
                       1).astype(np.float64)
        want = np.array([[t["neck_shaft_deg"], t["retroversion_deg"],
                          t["head_radius"]] for t in truth])
        ref = np.array([[r["ns"], r["rv"], r["r"]]
                        for r in jax_rows[name]["rows"]])
        err, vs_jax = got - want, got - ref
        for i, t in enumerate(truth):
            log(f"accuracy {name} bone {i} ({t['side']}): neck-shaft "
                f"{got[i, 0]:.3f} (truth {want[i, 0]:.3f}, JAX "
                f"{ref[i, 0]:.3f}), retroversion {got[i, 1]:.3f} (truth "
                f"{want[i, 1]:.3f}, JAX {ref[i, 1]:.3f}), radius "
                f"{got[i, 2]:.3f} (truth {want[i, 2]:.3f}, JAX "
                f"{ref[i, 2]:.3f}); port - JAX {np.round(vs_jax[i], 4)}")
        bnd = ACC_BOUNDS[name]
        summary = {"max_abs_err": np.abs(err).max(0).tolist(),
                   "mean_err": err.mean(0).tolist(),
                   "max_abs_vs_jax": np.abs(vs_jax).max(0).tolist(),
                   "vs_jax": vs_jax.tolist(), "ingest_s": ingest_s,
                   "batch_s": batch_s, "ingest": ingest, "specs": specs,
                   "truth": truth, "lm": lm}
        log(f"accuracy {name}: |error| max (ns, rv, radius) "
            f"{np.round(summary['max_abs_err'], 3)}, mean "
            f"{np.round(summary['mean_err'], 3)}, |port - JAX| max "
            f"{np.round(summary['max_abs_vs_jax'], 4)}; ingest "
            f"{ingest_s:.1f} s, landmark batch {batch_s:.2f} s ({smi})")
        sides = [bool(x) for x in lm.side_is_left]
        if sides != [t["side"] == "left" for t in truth]:
            raise AssertionError(f"accuracy {name}: a side is wrong")
        limits = (bnd["ns"], bnd["rv"], bnd["rad"])
        if not (np.isfinite(err).all()
                and (np.abs(err).max(0) < limits).all()
                and abs(err[:, 0].mean()) < bnd["mean_ns"]
                and abs(err[:, 1].mean()) < bnd["mean_rv"]):
            raise AssertionError(f"accuracy {name}: outside BOUNDS {bnd}")
        if name == "healthy" and not (np.abs(vs_jax) < ACC_GATE).all():
            raise AssertionError("accuracy healthy: a bone differs from the "
                                 "JAX package's row")
        if name == "arthritic" and not (np.abs(vs_jax)
                                        < ACC_ARTHRITIC_GATE).all():
            raise AssertionError(f"accuracy arthritic: a bone lies beyond "
                                 f"{ACC_ARTHRITIC_GATE} of its JAX row")
        out[name] = summary
    out["total_s"] = time.perf_counter() - t_phase
    log(f"accuracy phase: {out['total_s']:.1f} s in all ({smi})")
    return out


def rigid_frame(rng):
    """tests/test_rigid_invariance.py's `_rigid`: (rotation, translation)
    from a random unit quaternion and a shift within 150 mm."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    t = rng.uniform(-150, 150, size=3)
    return rot, t


def rigid_meshes():
    """The rigid test's bone under its RIGID_FRAMES frames from
    default_rng(42): ([(rotation, translation, float32 vertices)], int32
    faces)."""
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

    v0, f = synthetic_humerus(**RIGID_BONE)
    rng = np.random.default_rng(42)
    frames = []
    for _ in range(RIGID_FRAMES):
        rot, t = rigid_frame(rng)
        frames.append((rot, t, (v0 @ rot.T + t).astype(np.float32)))
    return frames, f.astype(np.int32)


def rigid_specs(frames, faces, cfg):
    """One BoneSpec per frame, through the port's spec_from_arrays."""
    from shoulder_tpu_torch.io import ingest, stl

    nbr, wt = stl.edge_face_adjacency(faces)
    return [ingest.spec_from_arrays(f"frame{i}", v, faces, nbr, wt,
                                    config=cfg)
            for i, (_, _, v) in enumerate(frames)]


def rigid_spread(frames, lm):
    """The rigid test's measures over the frames' landmarks `lm` (numpy):
    each metric's spread, whether all are finite, the bones called left,
    the spread of the anatomic-neck plane points mapped back to the
    build frame (mm, largest over x, y, z) and the largest angle of a
    mapped-back normal from frame 0's (deg)."""
    pts, normals = [], []
    for i, (rot, t, _) in enumerate(frames):
        n = np.asarray(lm.anp_plane_normal[i]) @ rot
        pts.append((np.asarray(lm.anp_plane_point[i]) - t) @ rot)
        normals.append(n if n[2] >= 0 else -n)
    angles = [np.degrees(np.arccos(np.clip(np.dot(normals[0], n), -1, 1)))
              for n in normals[1:]]
    metrics = ("neckshaft", "retroversion", "radius_curvature")
    out = {name: float(np.ptp(getattr(lm, name))) for name in metrics}
    out.update(
        finite=bool(all(np.isfinite(getattr(lm, m)).all() for m in metrics)),
        left=int(np.asarray(lm.side_is_left).sum()),
        point_ptp=float(np.ptp(np.stack(pts), axis=0).max()),
        normal_deg=float(max(angles)))
    return out


def rigid_failures(spread):
    """The gates of tests/test_rigid_invariance.py that `spread`
    (rigid_spread) fails: a right bone in every frame."""
    g = RIGID_GATES
    fails = [name for name in ("neckshaft", "retroversion",
                               "radius_curvature")
             if not spread[name] < g["metric_ptp"]]
    fails += [name for name, ok in (
        ("finite", spread["finite"]), ("side", spread["left"] == 0),
        ("point_ptp", spread["point_ptp"] < g["point_ptp"]),
        ("normal_deg", spread["normal_deg"] < g["normal_deg"])) if not ok]
    return fails


def pitch_config():
    """tools/eval_ct_pitch.py's make_cfg: tiny_config's stacks with the
    padded sizes of a 1.0 mm CT mesh (band 6144, k 1024)."""
    from shoulder_tpu_torch.config import SliceSetConfig, tiny_config

    return dataclasses.replace(
        tiny_config(max_faces=300000, max_verts=160000),
        full=SliceSetConfig(zslice_num=64, interp_num=64, band=6144),
        proximal=SliceSetConfig(zslice_num=96, interp_num=128, band=6144),
        distal=SliceSetConfig(zslice_num=48, interp_num=96, band=6144),
        max_chain=1024,
        slice_compact_k=1024,
    )


def pitch_mesh_spec(cfg):
    """The pitch sweep's direct mesh: its bone, 220 rings of 192."""
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

    v, f = synthetic_humerus(n_rings=220, n_theta=192, **CT_BONE_KW)
    nb, wt = stl.edge_face_adjacency(f)
    return ingest.spec_from_arrays("direct", v, f, nb, wt, config=cfg)


def pitch_ct_spec(pitch, cfg, device):
    """The pitch sweep's CT bone at `pitch` mm: a 320 x 144 x 144 mm
    volume (seed 1, 15 HU noise) cut at PITCH_ISO_HU, marching tets on
    `device`, the native weld."""
    from shoulder_tpu_torch.pipeline import ct

    shape = tuple(int(round(mm / pitch)) for mm in (320.0, 144.0, 144.0))
    vol, origin, spacing = ct.synth_ct_volume(
        shape=shape, spacing=(pitch,) * 3, seed=1, noise_hu=15.0,
        **CT_BONE_KW)
    seg, iso = ct.segment_volume(vol, "threshold", iso_hu=PITCH_ISO_HU,
                                 device=device)
    return ct.volume_to_spec(seg, origin, spacing, iso, config=cfg,
                             max_tris=CT_MAX_TRIS, device=device)


def pitch_deltas(lm, i=1):
    """CT bone i minus direct mesh (0) of a batch's landmarks (numpy),
    keyed as tools/eval_ct_pitch_results.json's rows."""
    return {f"d_{key}": float(getattr(lm, name)[i]) - float(
        getattr(lm, name)[0]) for key, name in (
            ("ns", "neckshaft"), ("rv", "retroversion"),
            ("rad", "radius_curvature"), ("neck_z", "neck_z"))}


def pitch_row(pitch):
    """The JAX package's row of tools/eval_ct_pitch_results.json."""
    return next(r for r in tool_json("eval_ct_pitch_results.json")["rows"]
                if r["pitch_mm"] == pitch)


def robust_cohort(td, cfg):
    """tests/test_arthritic_cohort.py's cohort: ROBUST_VARIANTS from one
    default_rng(7) stream, 60 rings of 48, written as STLs into td and
    loaded by the port's load_bone at cfg."""
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus

    rng = np.random.default_rng(7)
    specs = []
    for i, kw in enumerate(ROBUST_VARIANTS):
        v, f = synthetic_humerus(rng_transform=rng, n_rings=60, n_theta=48,
                                 **kw)
        path = os.path.join(td, f"robust{i}.stl")
        stl.write_stl(path, v, f)
        specs.append(ingest.load_bone(path, config=cfg))
    return specs


def robust_failures(lm):
    """The checks of tests/test_arthritic_cohort.py that the cohort's
    landmarks `lm` (numpy) fail."""
    finite = all(np.isfinite(getattr(lm, name)).all() for name in (
        "neckshaft", "retroversion", "radius_curvature", "canal_axis",
        "te_axis"))
    return [name for name, ok in (
        ("finite", finite),
        ("qc_sphere_resid", lm.qc_sphere_resid[3] > lm.qc_sphere_resid[0]),
        ("healthy bone", 60.0 < lm.neckshaft[0] < 180.0
         and lm.radius_curvature[0] > 5.0),
        ("overflow", not lm.qc_slice_overflow.any())) if not ok]


def one_batch(name, launches):
    """Raise unless the launches since reset_launches() are one batch's:
    3 slice-stack, 1 raw-loop, no walk; record them in launches[name]."""
    launches[name] = launch_counts()
    if launches[name] != (3, 1, 0):
        raise AssertionError(f"{name}: (slice-stack, raw-loop, walk) "
                             f"launches {launches[name]}, expected (3, 1, 0)")


def landmark_batch(specs, dev, rf, cfg, seg2d=None):
    """compute_landmarks_batch of specs on dev, as the JAX tests call it
    (chunk 16)."""
    from shoulder_tpu_torch.pipeline import batch as B

    return B.compute_landmarks_batch(B.stack_bones(specs, dev), rf, cfg=cfg,
                                     seg_model=seg2d, chunk=16)


def rigid_leg(dev, rf, seg2d, smi, launches, ingest):
    """Phase 14a: the rigid test's bone under its frames, one batch at
    DEFAULT_CONFIG with the UNet, under the rigid test's gates."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.pipeline import batch as B

    t0 = time.perf_counter()
    with ingest_split(split := {}):
        frames, faces = rigid_meshes()
        specs = rigid_specs(frames, faces, DEFAULT_CONFIG)
    ingest["rigid"] = ingest_check("robustness rigid", split, smi,
                                   n_specs=RIGID_FRAMES)
    reset_launches()
    lm = B.landmarks_to_numpy(landmark_batch(specs, dev, rf, DEFAULT_CONFIG,
                                             seg2d))
    one_batch("rigid", launches)
    spread = rigid_spread(frames, lm)
    out = dict(spread, neckshaft_deg=lm.neckshaft.tolist(),
               retroversion_deg=lm.retroversion.tolist(),
               radius_mm=lm.radius_curvature.tolist(),
               s=time.perf_counter() - t0)
    log(f"robustness rigid: {RIGID_FRAMES} frames in one batch, spread "
        f"neck-shaft {spread['neckshaft']:.4f}, retroversion "
        f"{spread['retroversion']:.4f}, radius "
        f"{spread['radius_curvature']:.4f}, bones called left "
        f"{spread['left']}, plane points {spread['point_ptp']:.4f} mm, "
        f"normals {spread['normal_deg']:.4f} deg (gates {RIGID_GATES}); "
        f"{out['s']:.1f} s ({smi})")
    if fails := rigid_failures(spread):
        raise AssertionError(f"robustness rigid: fails {fails}")
    return out


def segmenter_leg(dev, rf, seg2d, acc, smi, launches, ingest):
    """Phase 14b: phase 11's cohorts (`acc`) under the sphere segmenter
    against tools/eval_accuracy_sphere.json, then the A/B tripwire.  Each
    cohort's sphere-arm landmarks are kept in acc[name]["sphere_lm"] for
    phase 16."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.pipeline import batch as B

    t0 = time.perf_counter()
    sphere = dataclasses.replace(DEFAULT_CONFIG, segmenter="sphere")
    rows = tool_json("eval_accuracy_sphere.json")
    out = {"sphere": {}, "tripwire": {}}
    for name, gate in (("healthy", (ACC_GATE,) * 3),
                       ("arthritic", ACC_ARTHRITIC_GATE)):
        specs, truth = acc[name]["specs"], acc[name]["truth"]
        reset_launches()
        lm = B.landmarks_to_numpy(landmark_batch(specs, dev, rf, sphere))
        one_batch(f"sphere {name}", launches)
        acc[name]["sphere_lm"] = lm
        got = np.stack([lm.neckshaft, lm.retroversion, lm.radius_curvature],
                       1).astype(np.float64)
        want = np.array([[t["neck_shaft_deg"], t["retroversion_deg"],
                          t["head_radius"]] for t in truth])
        ref = np.array([[r["ns"], r["rv"], r["r"]]
                        for r in rows[name]["rows"]])
        if not np.array_equal(want[:, 0], [r["ns_truth"]
                                           for r in rows[name]["rows"]]):
            raise AssertionError(f"robustness sphere {name}: the cohort is "
                                 f"not the rows' cohort")
        vs_jax = got - ref
        for i, t in enumerate(truth):
            log(f"robustness sphere {name} bone {i} ({t['side']}): port "
                f"{np.round(got[i], 4)}, JAX row {np.round(ref[i], 4)}, "
                f"truth {np.round(want[i], 4)}, port - JAX "
                f"{np.round(vs_jax[i], 4)}")
        out["sphere"][name] = {"vs_jax": vs_jax.tolist(),
                               "max_abs_vs_jax":
                                   np.abs(vs_jax).max(0).tolist()}
        # the JAX package's sphere arm calls some arthritic sides wrong
        # (its rows' side_ok): the port must call each side as it does
        side_ok = [bool(x) == (t["side"] == "left")
                   for x, t in zip(lm.side_is_left, truth)]
        out["sphere"][name]["side_ok"] = side_ok
        if side_ok != [r["side_ok"] for r in rows[name]["rows"]]:
            raise AssertionError(f"robustness sphere {name}: a side differs "
                                 f"from its JAX row's")
        if not (np.abs(vs_jax) < gate).all():
            raise AssertionError(f"robustness sphere {name}: a bone lies "
                                 f"beyond {gate} of its JAX row")
    rng = np.random.default_rng(77)
    for name in ("healthy", "arthritic"):
        with ingest_split(split := {}):
            specs, truth = accuracy_cohort(rng, name == "arthritic",
                                           AB_PER_COHORT)
        ingest[f"tripwire {name}"] = ingest_check(
            f"robustness tripwire {name}", split, smi)
        want = np.array([[t["neck_shaft_deg"], t["retroversion_deg"],
                          t["head_radius"]] for t in truth])
        err = {}
        for seg in ("unet", "sphere"):
            reset_launches()
            lm = B.landmarks_to_numpy(landmark_batch(
                specs, dev, rf,
                dataclasses.replace(DEFAULT_CONFIG, segmenter=seg),
                seg2d if seg == "unet" else None))
            one_batch(f"tripwire {name} {seg}", launches)
            err[seg] = np.abs(np.stack([lm.neckshaft, lm.retroversion,
                                        lm.radius_curvature], 1) - want)
        worse = err["unet"].max(0) - err["sphere"].max(0)
        out["tripwire"][name] = {seg: e.tolist() for seg, e in err.items()}
        out["tripwire"][name]["unet_worse_by"] = worse.tolist()
        log(f"robustness tripwire {name}: |max| error (ns, rv, radius) unet "
            f"{np.round(err['unet'].max(0), 3)}, sphere "
            f"{np.round(err['sphere'].max(0), 3)}, unet worse by "
            f"{np.round(worse, 3)} (margin {AB_MARGIN})")
        if not (np.isfinite(err["unet"]).all()
                and (worse < [AB_MARGIN[m] for m in ("ns", "rv", "rad")]
                     ).all()):
            raise AssertionError(f"robustness tripwire {name}: the UNet arm "
                                 f"loses to the sphere arm beyond the margin")
    out["s"] = time.perf_counter() - t0
    log(f"robustness segmenters: {out['s']:.1f} s ({smi})")
    return out


def ct_pitch_leg(dev, rf, smi, launches, ingest):
    """Phase 14c: the pitch sweep's bone as its direct mesh and as a CT
    volume at each of PITCHES, segmented and meshed on the card, against
    the bounds (where PITCH_BOUNDS has them) and the JAX rows, the side as
    the row calls it."""
    from shoulder_tpu_torch.pipeline import batch as B

    t0 = time.perf_counter()
    cfg = pitch_config()
    with ingest_split(split := {}):
        mesh = pitch_mesh_spec(cfg)
        cts = {pitch: pitch_ct_spec(pitch, cfg, dev) for pitch in PITCHES}
    ingest["ct_pitch"] = ingest_check("robustness ct pitch", split, smi,
                                      n_specs=1 + len(PITCHES))
    out = {}
    for pitch in PITCHES:
        bnd = PITCH_BOUNDS.get(pitch, {})
        reset_launches()
        lm = B.landmarks_to_numpy(landmark_batch([mesh, cts[pitch]], dev, rf,
                                                 cfg))
        one_batch(f"ct {pitch} mm", launches)
        d, row = pitch_deltas(lm), pitch_row(pitch)
        same_side = bool(lm.side_is_left[0] == lm.side_is_left[1])
        out[pitch] = {"deltas": d, "jax_row": {key: row[key] for key in d},
                      "faces": cts[pitch].n_faces, "same_side": same_side,
                      "jax_side_ok": row["side_ok"]}
        log(f"robustness ct {pitch} mm ({cts[pitch].n_faces} faces): "
            + ", ".join(f"{key} {d[key]:+.5f} (JAX {row[key]:+.5f})"
                        for key in d)
            + f"; bounds {bnd or 'none'}, same side {same_side} (JAX "
            f"{row['side_ok']})")
        if not (same_side == row["side_ok"]
                and not lm.qc_slice_overflow.any()
                and all(abs(d[f"d_{key}"]) < b for key, b in bnd.items())
                and all(abs(d[key] - row[key]) < ACC_GATE for key in d)):
            raise AssertionError(f"robustness ct {pitch} mm: outside the "
                                 f"bounds, {ACC_GATE} from the JAX row or "
                                 f"the side not as the row calls it")
    out["s"] = time.perf_counter() - t0
    log(f"robustness ct pitches: {out['s']:.1f} s ({smi})")
    return out


def nan_trap_leg(td, dev, rf, seg2d, bones, lm, smi, launches, ingest):
    """Phase 14d: phase 4's batch (`bones`, its landmarks `lm`) and the
    arthritic cohort under the NaN trap: no site, and the landmarks bit
    for bit the untrapped run's.  Each check waits for the card, so this
    runs after phase 6's sync counts and outside any timed region."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG, tiny_config
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.utils import nan_trap

    t0 = time.perf_counter()
    tiny = tiny_config()
    with ingest_split(split := {}):
        robust = B.stack_bones(robust_cohort(td, tiny), dev)
    ingest["arthritic"] = ingest_check("robustness arthritic", split, smi,
                                       n_specs=len(ROBUST_VARIANTS))
    reset_launches()
    lm_a = B.compute_landmarks_batch(robust, rf, cfg=tiny, chunk=16)
    one_batch("arthritic cohort", launches)
    if fails := robust_failures(B.landmarks_to_numpy(lm_a)):
        raise AssertionError(f"robustness arthritic cohort: fails {fails}")
    out = {}
    for name, batch, cfg, seg, ref in (
            ("phase 4 batch", bones, DEFAULT_CONFIG, seg2d, lm),
            ("arthritic cohort", robust, tiny, None, lm_a)):
        reset_launches()
        with nan_trap.trap(raise_first=False) as mode:
            got = B.compute_landmarks_batch(batch, rf, cfg=cfg,
                                            seg_model=seg, chunk=16)
        checked = port_launches()
        one_batch(f"nan trap {name}", launches)
        res = out[name] = {
            "aten_calls": mode.calls, "kernel_launches": checked,
            "n_sites": len(mode.sites),
            "sites": [dataclasses.asdict(s) for s in mode.sites[:20]],
            "equal": same_stack(got, ref)}
        log(f"robustness nan trap, {name}: {mode.calls} aten calls and "
            f"{checked} kernel launches checked, {len(mode.sites)} sites "
            f"{mode.sites[:3]}, landmarks bit for bit the untrapped run's: "
            f"{res['equal']}")
        if mode.sites or not res["equal"]:
            raise AssertionError(f"robustness nan trap, {name}: a NaN site "
                                 f"or landmarks that differ")
    out["s"] = time.perf_counter() - t0
    log(f"robustness nan trap: {out['s']:.1f} s ({smi})")
    return out


def robustness_phase(td, dev, rf, seg2d, acc, bones, lm, smi):
    """Phase 14: the JAX package's robustness checks on the card, each
    leg's batches one launch of each kernel per stack: (a) rigid frames,
    (b) the sphere segmenter and the A/B tripwire, (c) both CT pitches,
    (d) the NaN trap."""
    t_phase = time.perf_counter()
    launches, ingest = {}, {}
    out = {"rigid": rigid_leg(dev, rf, seg2d, smi, launches, ingest),
           "segmenters": segmenter_leg(dev, rf, seg2d, acc, smi, launches,
                                       ingest),
           "ct_pitch": ct_pitch_leg(dev, rf, smi, launches, ingest),
           "nan_trap": nan_trap_leg(td, dev, rf, seg2d, bones, lm, smi,
                                    launches, ingest),
           "launches": launches, "ingest": ingest}
    out["total_s"] = time.perf_counter() - t_phase
    log(f"robustness phase: {out['total_s']:.1f} s in all ({smi})")
    return out


def ingest_both_ways(path, spec, smi):
    """Phase 4's oracle check: bone 0 through the native ingest and through
    the numpy oracle; both timed."""
    from shoulder_tpu_torch.host import obb
    from shoulder_tpu_torch.io import ingest, stl

    t0 = time.perf_counter()
    got = ingest.load_bone(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = stl.load_indexed_numpy(path)
    with swapped(obb, "oriented_bounds", obb.oriented_bounds_numpy):
        want = ingest.spec_from_arrays(got.name, *mesh)
    numpy_s = time.perf_counter() - t0
    for g, w in zip(stl.load_indexed(path), mesh):
        if not (np.asarray(g).dtype == np.asarray(w).dtype
                and np.array_equal(g, w)):
            raise AssertionError("load_indexed: native and numpy differ")
    for name in ("vertices", "faces", "neighbors", "face_orig"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"bone 0 {name}: native and numpy differ")
    if not spec_equal(got, spec):
        raise AssertionError("bone 0: a second native ingest differs")
    d_obb = float(np.abs(got.obb_transform - want.obb_transform).max())
    d_z = float(np.abs(np.subtract(got.z_bounds, want.z_bounds)).max())
    log(f"ingest bone 0, native {native_s * 1e3:.1f} ms vs numpy oracle "
        f"{numpy_s * 1e3:.1f} ms: meshes and presorted faces equal, "
        f"|obb_transform| {d_obb:.3g}, |z_bounds| {d_z:.3g} ({smi})")
    if not (d_obb < 1e-6 and d_z < 1e-6):
        raise AssertionError("bone 0: native and numpy boxes differ")
    return {"bone0_native_ms": native_s * 1e3, "bone0_numpy_ms": numpy_s * 1e3,
            "bone0_obb_diff": d_obb, "bone0_z_bounds_diff": d_z}


def spec_equal(a, b):
    """Every array and number of two BoneSpecs equal."""
    return all(np.array_equal(np.asarray(getattr(a, f.name)),
                              np.asarray(getattr(b, f.name)))
               for f in dataclasses.fields(a) if f.name != "name")


def in_turns(runs, pairs=REPS + 1):
    """Synchronized ms of each of two calls (`runs`, name -> callable),
    in turns (a, b, b, a, ...), `pairs` of each, after one warm call
    each: {name: [...]}."""
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    (a, fa), (b, fb) = runs.items()
    timed(fa)
    timed(fb)
    out = {a: [], b: []}
    for i in range(pairs):
        for name in ((a, b) if i % 2 == 0 else (b, a)):
            out[name].append(timed(runs[name]))
    return out


def eager_batch(bones, rf, seg):
    """A batch's landmarks at DEFAULT_CONFIG with the UNet and the stages
    eager (landmarks._stages, no CUDA graph), so a function swapped into
    a stage runs."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.pipeline import landmarks as L

    return L._stages(bones, rf, False, DEFAULT_CONFIG, 150, seg, None)


def ab_timing(bones, rf, seg, pairs=REPS + 1):
    """Synchronized batch ms of the stages eager (eager_batch) with the
    plain raw loop (plain_raw_banded) and with the raw-loop kernel, in
    turns (plain, kernel, kernel, plain, ...), `pairs` of each, after one
    warm run each: {"plain": [...], "kernel": [...]}."""
    from shoulder_tpu_torch.ops import slicing

    def run(plain):
        with (swapped(slicing, "slice_raw_banded", plain_raw_banded)
              if plain else contextlib.nullcontext()):
            eager_batch(bones, rf, seg)

    return in_turns({"plain": lambda: run(True),
                     "kernel": lambda: run(False)}, pairs)


def batch_timing(bones, rf, seg, smi, reps=REPS, eager=False):
    """Phase 6 for one batch on the main path (or with the stages eager,
    eager_batch): one profiled run (kernel launches: the profiler's
    cudaLaunchKernel and every launch API call, plus the port's own
    kernels' launches from the host, which it does not count; the
    device's busy time and idle share), two runs under
    set_sync_debug_mode("warn") (the second's synchronizing calls
    counted: the first run so watched in a process counts one more,
    whichever path it takes), then `reps` warm synchronized runs (p50)."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.utils import bench

    n = bones.verts.shape[0]

    def run():
        if eager:
            eager_batch(bones, rf, seg)
        else:
            B.compute_landmarks_batch(bones, rf, cfg=DEFAULT_CONFIG,
                                      seg_model=seg)

    run()
    torch.cuda.synchronize()
    counted = bench.count_launches(run)
    api, port = counted["launch_api"], counted["port_launches"]
    wall_ms = counted["wall_ms"]
    busy_ms = load_tool("profile_torch_batch")._busy_ms(counted["prof"])
    syncs = bench.count_syncs(run)

    lat = []
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - resident
    res = {"bones": n, "cudaLaunchKernel": api.get("cudaLaunchKernel", 0),
           "resident_bytes": resident, "peak_bytes": peak,
           "launch_api": api, "port_launches": port,
           "launches": counted["launches"], "syncs": syncs,
           "profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms, "batch_ms": lat,
           "p50_ms": float(np.median(lat)) if lat else None}
    log(f"batch of {n}{', stages eager' if eager else ''}: "
        f"{res['launches']} kernel launches ({api}, plus "
        f"{port} of the port's kernels), {syncs} synchronizing calls; "
        f"profiled run {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
        f"share {res['idle_share']:.3f}"
        + (f"; batch ms " + ", ".join(f"{t:.1f}" for t in lat)
           + f", p50 {res['p50_ms']:.1f}; peak memory above the "
           f"{resident / 2**20:.1f} MiB resident {peak / 2**20:.1f} MiB"
           if lat else "") + f" ({smi})")
    return res


def graphs_timing(bones, rf, seg, eager, smi, reps=REPS):
    """Phase 6's counts and times of one batch on the main path, each
    stage a CUDA graph's replay after its first call (pipeline/graphs.py),
    printed beside the eager run's (`eager`, batch_timing's with the
    stages eager) with the graphs' counters over the calls: the replays,
    and no fallback."""
    from shoulder_tpu_torch.pipeline import graphs
    from shoulder_tpu_torch.utils import trace

    before = {name: trace.counter(name) for name in graphs.COUNTERS}
    res = batch_timing(bones, rf, seg, smi, reps=reps)
    res["counters"] = {name: trace.counter(name) - before[name]
                       for name in graphs.COUNTERS}
    n = bones.verts.shape[0]
    log(f"batch of {n}, eager -> CUDA graphs: launches {eager['launches']}"
        f" -> {res['launches']} (launch API calls {eager['launch_api']} -> "
        f"{res['launch_api']}), synchronizing calls {eager['syncs']} -> "
        f"{res['syncs']}, device busy {eager['busy_ms']:.1f} -> "
        f"{res['busy_ms']:.1f} ms, idle share {eager['idle_share']:.3f} -> "
        f"{res['idle_share']:.3f}, p50 {eager['p50_ms']:.1f} -> "
        f"{res['p50_ms']:.1f} ms; graphs counters {res['counters']} ({smi})")
    if res["counters"]["graphs.fallbacks"] or not res["counters"][
            "graphs.replays"]:
        raise AssertionError(f"batch of {n}: CUDA graphs fell back or did "
                             f"not replay: {res['counters']}")
    if res["syncs"] > eager["syncs"]:
        raise AssertionError(f"batch of {n}: the replay added synchronizing "
                             f"calls")
    return res


def bench_phase(phase6, bones, rf, seg, smi):
    """Phase 15: the measurement entry points on the card.  bench_torch.py
    at DEFAULT_CONFIG, batch BATCH, REPS reps: its gate passed, 3
    slice-stack and 1 raw-loop launches per batch run, no walk launch or
    plain compaction, and one run's launches and synchronizing calls
    equal to phase 6's batch of BATCH (`phase6`); its batch (one bone
    replicated) and phase 4's (`bones`, BATCH bones) timed in turns, each
    profiled once for the device's busy time; then
    tools/bench_cohort_torch.py with its defaults (4 synthetic bones x
    16, batch 8, a cold and a warm pass): a row per bone, each bone's
    side its synthetic truth, 3 and 1 launches per batch."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.ops import slicing
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.utils import bench

    bench_torch = load_script("bench_torch.py")
    bench_cohort = load_script(os.path.join("tools",
                                            "bench_cohort_torch.py"))
    t_phase = time.perf_counter()
    out, ingest = {}, {}

    buf = io.StringIO()
    reset_launches()
    with ingest_split(split := {}), counted_profiles(), \
            recording(slicing, "_compact_slice", []) as compactions:
        res = bench_torch.run_bench("cuda", DEFAULT_CONFIG, BATCH, REPS,
                                    out=buf)
    launches = launch_counts()
    ingest["bench"] = ingest_check("bench", split, smi, n_specs=1)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"bench_torch: {json.dumps(line)}; p50 {res['p50_ms']:.1f} ms, "
        f"phase 6 p50 {phase6['p50_ms']:.1f} ms "
        f"({min(phase6['batch_ms']):.1f}-{max(phase6['batch_ms']):.1f}); "
        f"launches {res['launches']} (phase 6 {phase6['launches']}), "
        f"synchronizing calls {res['syncs']} (phase 6 {phase6['syncs']}); "
        f"(slice-stack, raw-loop, walk) launches {launches} over "
        f"{res['runs']} batch runs ({smi})")
    if not line["value"] > 0:
        raise AssertionError(f"bench_torch: the sanity gate failed, means "
                             f"{res['means']}")
    if launches != (3 * res["runs"], res["runs"], 0) or compactions:
        raise AssertionError(f"bench_torch: launches {launches} over "
                             f"{res['runs']} runs, {len(compactions)} plain "
                             f"compactions")
    if (res["launches"], res["syncs"]) != (phase6["launches"],
                                           phase6["syncs"]):
        raise AssertionError("bench_torch: launches or synchronizing calls "
                             "differ from phase 6's")
    out["bench"] = dict(res, phase6_p50_ms=phase6["p50_ms"])
    out["launches"] = {"bench": launches}

    spec, _ = bench_torch.bench_bone()
    bench_bones = B.stack_bones([spec] * BATCH, bones.verts.device)

    def run(batch):
        return lambda: B.compute_landmarks_batch(batch, rf, cfg=DEFAULT_CONFIG,
                                                 seg_model=seg)

    runs = {"phase 4": run(bones), "bench": run(bench_bones)}
    turns = in_turns(runs)
    busy_ms = load_tool("profile_torch_batch")._busy_ms
    busy = {name: busy_ms(bench.count_launches(fn)["prof"])
            for name, fn in runs.items()}
    log(f"batch of {BATCH}, phase 4's bones / the bench's one bone x "
        f"{BATCH}, in turns: "
        + "; ".join(f"{name} median {np.median(ms):.1f} ms "
                    f"({min(ms):.1f}-{max(ms):.1f}), device busy "
                    f"{busy[name]:.1f} ms" for name, ms in turns.items())
        + f" ({smi})")
    out["bench"].update({"turns_ms": turns, "busy_ms": busy})

    reset_launches()
    with tempfile.TemporaryDirectory() as td, ingest_split(split := {}):
        paths = [p for p in bench_cohort.cohort_bones(td, bones_dir="")
                 for _ in range(16)]
        rows, stats, wall = bench_cohort.run_cohort(paths, "cuda",
                                                    DEFAULT_CONFIG, 8)
    launches = launch_counts()
    ingest["cohort"] = ingest_check("bench cohort", split, smi,
                                    n_specs=2 * len(paths))
    batches = 2 * (len(paths) // 8)
    wrong = [r["name"] for r in rows
             if r["side"] != r["name"].split("_")[1]]
    log(f"bench_cohort_torch: {len(rows)} bones, warm pass {wall:.3f} s = "
        f"{len(paths) / wall:.3f} bones/s with ingest; summary {stats}; "
        f"(slice-stack, raw-loop, walk) launches {launches} over {batches} "
        f"batches; sides wrong {wrong} ({smi})")
    if len(rows) != 64 or wrong:
        raise AssertionError(f"bench_cohort_torch: {len(rows)} rows, sides "
                             f"wrong {wrong}")
    if launches != (3 * batches, batches, 0):
        raise AssertionError(f"bench_cohort_torch: launches {launches} over "
                             f"{batches} batches")
    out["cohort"] = {"bones": len(rows), "warm_s": wall,
                     "bones_per_s": len(paths) / wall, "summary": stats}
    out["launches"]["cohort"] = launches
    out["ingest"] = ingest
    out["total_s"] = time.perf_counter() - t_phase
    log(f"bench phase: {out['total_s']:.1f} s in all ({smi})")
    return out


def articular_leg(dev, rf, seg, smi, launches, ingest):
    """Phase 16a: tools/eval_articular_torch.py's cohorts at
    DEFAULT_CONFIG with the UNet, each eval batch exactly 2 slice-stack
    and 1 raw-loop launches, every bone's row against its JAX row."""
    from shoulder_tpu_torch.config import DEFAULT_CONFIG as cfg
    from shoulder_tpu_torch.ops import kernels, slicing

    EA = load_tool("eval_articular_torch")
    ref = tool_json("eval_articular_rows_jax.json")["articular"]
    lib = kernels.library()
    for name in ("full", "proximal"):
        band = getattr(cfg, name).band
        log(f"evidence articular: slice-stack shared memory, {name} stack "
            f"at k {EA.COMPACT_K}: "
            f"{lib.slice_stack_smem_bytes(band, min(band, EA.COMPACT_K))} B "
            f"dynamic per block")
    per_batch, eval_rows = [], EA.eval_rows

    def counted(*args, **kwargs):
        reset_launches()
        out = eval_rows(*args, **kwargs)
        per_batch.append(launch_counts())
        return out

    n = len(ref["healthy"]["rows"])
    t0 = time.perf_counter()
    with swapped(EA, "eval_rows", counted), ingest_split(split := {}), \
            recording(slicing, "_compact_slice", []) as compactions:
        res = EA.run_cohorts(n, dev, cfg, rf, seg)
    secs = time.perf_counter() - t0
    ingest["articular"] = ingest_check("evidence articular", split, smi,
                                       n_specs=2 * n)
    launches["articular"] = tuple(int(x) for x in np.sum(per_batch, 0))
    log(f"evidence articular: (slice-stack, raw-loop, walk) launches per "
        f"eval batch {per_batch}, {len(compactions)} plain compactions")
    if any(c != (2, 1, 0) for c in per_batch) or compactions:
        raise AssertionError("evidence articular: an eval batch is not 2 "
                             "slice-stack and 1 raw-loop launches")
    out = {"s": secs, "summary": EA.summarize(res),
           "jax_summary": EA.summarize({
               kind: {"rows": np.asarray(d["rows"], np.float32),
                      "flattening": np.asarray(d["flattening"])}
               for kind, d in ref.items()}),
           "max_abs_vs_jax": {}}
    for kind, (ga, gn, gr) in (("healthy", (ACC_GATE,) * 3),
                               ("arthritic", ACC_ARTHRITIC_GATE)):
        got = res[kind]["rows"].astype(np.float64)
        want = np.asarray(ref[kind]["rows"], np.float64)
        if not np.array_equal(res[kind]["flattening"],
                              ref[kind]["flattening"]):
            raise AssertionError(f"evidence articular {kind}: the cohort is "
                                 f"not the rows' cohort")
        diff = np.abs(got - want)
        limits = np.array([EVIDENCE_IOU] * 3 + [ga] * 2 + [gn] * 2
                          + [gr] * 2 + [0.0])
        for i in range(len(got)):
            log(f"evidence articular {kind} bone {i}: port "
                f"{np.round(got[i], 4).tolist()}, port - JAX "
                f"{np.round(got[i] - want[i], 4).tolist()}")
        out["max_abs_vs_jax"][kind] = dict(zip(EA.COLS, diff.max(0)))
        log(f"evidence articular {kind}: largest |port - JAX| per column "
            + ", ".join(f"{c} {v:.4f}" for c, v in
                        out["max_abs_vs_jax"][kind].items())
            + f" (limits {limits.tolist()})")
        ok = (diff <= limits) | (np.isnan(got) & np.isnan(want))
        if not ok.all():
            raise AssertionError(
                f"evidence articular {kind}: bones {np.where(~ok)[0]} "
                f"columns {np.where(~ok)[1]} beyond the gates")
    for name, s in out["summary"].items():
        j = out["jax_summary"][name]
        log(f"evidence articular summary {name} (n={s['n']}), port / JAX: "
            + ", ".join(f"{c} {s[c]:.3f} / {j[c]:.3f}" for c in EA.COLS))
    log(f"evidence articular: {secs:.1f} s ({smi})")
    return out


def ab_leg(dev, rf, seg, smi, launches, ingest):
    """Phase 16b: tools/eval_arthritic_ab_torch.py's cohort, both arms one
    batch each, each bone's neck-shaft and qc_sphere_resid against its
    JAX row."""
    AB = load_tool("eval_arthritic_ab_torch")
    ref = tool_json("eval_articular_rows_jax.json")["ab"]
    t0 = time.perf_counter()
    with ingest_split(split := {}):
        specs, truth, draws = AB.make_cohort(len(ref))
    ingest["ab"] = ingest_check("evidence A/B", split, smi)
    if draws != [r["draw"] for r in ref]:
        raise AssertionError(f"evidence A/B: draws {draws}, the JAX rows' "
                             f"{[r['draw'] for r in ref]}")
    reset_launches()
    rows = AB.table(truth, draws, AB.run_arms(specs, dev, rf=rf,
                                              seg_model=seg))
    launches["ab"] = launch_counts()
    if launches["ab"] != (6, 2, 0):
        raise AssertionError(f"evidence A/B: launches {launches['ab']}, "
                             f"expected (6, 2, 0) for two batches")
    out = {"s": time.perf_counter() - t0, "max_abs_vs_jax": {}}
    for arm in AB.ARMS:
        d = np.array([[r[f"{arm}_ns"] - j[f"{arm}_ns"],
                       r[f"{arm}_resid"] - j[f"{arm}_resid"]]
                      for r, j in zip(rows, ref)])
        out["max_abs_vs_jax"][arm] = np.abs(d).max(0).tolist()
        log(f"evidence A/B {arm}: port - JAX per bone (neck-shaft deg, "
            f"resid mm) {np.round(d, 4).tolist()}")
        if not (np.abs(d) < AB_ROW_GATE).all():
            raise AssertionError(f"evidence A/B {arm}: a bone lies beyond "
                                 f"{AB_ROW_GATE} of its JAX row")
    log(f"evidence A/B: |port - JAX| max {out['max_abs_vs_jax']}; "
        f"{out['s']:.1f} s ({smi})")
    return out


def accuracy_tool_leg(dev, acc, smi, launches, ingest):
    """Phase 16c: tools/eval_accuracy_torch.py's cohorts and both arms,
    bit for bit phase 11's landmarks and phase 14b's (kept in `acc`)."""
    EACC = load_tool("eval_accuracy_torch")
    t0 = time.perf_counter()
    rng = np.random.default_rng(2026)
    for name in ("healthy", "arthritic"):
        with ingest_split(split := {}):
            specs, truth = EACC.make_cohort(ACC_PER_COHORT, rng,
                                            name == "arthritic")
        ingest[f"accuracy {name}"] = ingest_check(
            f"evidence accuracy {name}", split, smi)
        for seg, key in ((None, "lm"), ("sphere", "sphere_lm")):
            arm = seg or "default"
            reset_launches()
            lm = EACC.run_cohort(specs, dev, seg)
            one_batch(f"accuracy {name} {arm}", launches)
            EACC.table(f"{name} ({arm})", lm, truth)
            differ = [field for field, a, b in zip(lm._fields, lm,
                                                  acc[name][key])
                      if not np.array_equal(a, b, equal_nan=True)]
            if differ:
                raise AssertionError(f"evidence accuracy {name} {arm}: "
                                     f"{differ} differ from phase "
                                     f"{11 if seg is None else '14b'}'s")
    secs = time.perf_counter() - t0
    log(f"evidence accuracy: both cohorts, both arms bit for bit phases 11 "
        f"and 14b; {secs:.1f} s ({smi})")
    return {"s": secs}


def evidence_phase(dev, rf, seg, acc, smi):
    """Phase 16: the port's accuracy-evidence tools on the card, each held
    against the JAX package's rows or against phases 11 and 14b."""
    t_phase = time.perf_counter()
    launches, ingest = {}, {}
    out = {"articular": articular_leg(dev, rf, seg, smi, launches, ingest),
           "ab": ab_leg(dev, rf, seg, smi, launches, ingest),
           "accuracy": accuracy_tool_leg(dev, acc, smi, launches, ingest),
           "launches": launches, "ingest": ingest}
    out["total_s"] = time.perf_counter() - t_phase
    log(f"evidence phase: {out['total_s']:.1f} s in all ({smi})")
    return out


def mesh_phase(bones, lm, paths, cohort_res, smi):
    """Phase 12: parallel/mesh.py on the mesh of every card (one here)."""
    from shoulder_tpu_torch import cohort
    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.parallel import mesh as pmesh
    from shoulder_tpu_torch.pipeline import landmarks as L

    mesh = pmesh.bone_mesh()
    n_dev = len(mesh.devices)
    fn = pmesh.sharded_landmark_fn(mesh, cfg=DEFAULT_CONFIG)
    reset_launches()
    t0 = time.perf_counter()
    out = fn(pmesh.shard_bones(bones, mesh))
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches, raw_launches, walk_launches = launch_counts()
    if (launches, raw_launches, walk_launches) != (3 * n_dev, n_dev, 0):
        raise AssertionError(f"mesh: {launches} slice-stack, {raw_launches} "
                             f"raw-loop and {walk_launches} walk launches")
    home = lm.neck_z.device
    got = L.Landmarks(*(torch.cat([getattr(o, f).to(home) for o in out])
                        for f in L.Landmarks._fields))
    differ = [f for f, g, w in zip(L.Landmarks._fields, got, lm)
              if not same_tensor(g, w)]
    log(f"mesh: {n_dev} device(s) {[str(d) for d in mesh.devices]}, sharded "
        f"batch of {bones.verts.shape[0]} in {batch_ms:.1f} ms, {launches} "
        f"slice-stack and {raw_launches} raw-loop launches; fields differing "
        f"from phase 4: {differ}")
    if differ:
        raise AssertionError(f"mesh: {differ} differ from phase 4")

    stats = {k: float(v) for k, v in pmesh.cohort_stats(out, mesh).items()}
    lm_np = L.Landmarks(*(x.cpu().numpy() for x in lm))
    for name, field in (("retroversion", "retroversion"),
                        ("neckshaft", "neckshaft"),
                        ("radius", "radius_curvature")):
        x = getattr(lm_np, field).astype(np.float64)
        want = (np.nanmean(x), np.nanstd(x), float(np.isfinite(x).sum()))
        have = (stats[f"mean_{name}"], stats[f"std_{name}"],
                stats[f"n_{name}"])
        if not (abs(have[0] - want[0]) <= 1e-5 * max(1.0, abs(want[0]))
                and abs(have[1] - want[1]) <= 1e-4 and have[2] == want[2]):
            raise AssertionError(f"mesh: cohort_stats {name} {have} vs numpy "
                                 f"{want}")
    if stats["left_fraction"] != float(lm_np.side_is_left.mean()):
        raise AssertionError("mesh: cohort_stats left_fraction")
    log(f"mesh: cohort_stats {stats} (numpy's nanmean / nanstd agree)")

    t0 = time.perf_counter()
    res = cohort.process_cohort(paths, device_mesh=mesh, batch_size=4)
    wall = time.perf_counter() - t0

    def equal(a, b):
        if isinstance(a, list):
            return len(a) == len(b) and all(map(equal, a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b, equal_nan=True)
        return a == b or (a != a and b != b)

    log(f"mesh: process_cohort(device_mesh=...) {len(res)} bones in "
        f"{wall:.2f} s, equal to phase 8: {equal(res, cohort_res)}")
    if not equal(res, cohort_res):
        raise AssertionError("mesh: process_cohort on the mesh differs from "
                             "phase 8")
    return {"devices": n_dev, "launches": launches,
            "raw_launches": raw_launches, "batch_ms": batch_ms,
            "cohort_stats": stats, "cohort_s": wall}


def mesh_train_sections_phase(bones, lm, smi):
    """Phase 13: data-parallel UNet training over the one-card mesh, and
    the full-set and arbitrary-plane sections on the card against the
    CPU."""
    from shoulder_tpu_torch.models import unet_train
    from shoulder_tpu_torch.ops import rays, slicing
    from shoulder_tpu_torch.parallel import mesh as pmesh
    from shoulder_tpu_torch.utils import fits
    from shoulder_tpu_torch.utils import geometry as geom

    t_phase = time.perf_counter()
    mesh = pmesh.bone_mesh()
    # bit for bit needs the same kernels on both runs, so cuDNN takes its
    # deterministic algorithms here (the default ones may use atomics)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        # train()'s loop with the one-device train_step for mesh_step
        gen = unet_train.training_generator(None, 0, mesh.devices[0])
        plain = unet_train.new_model(gen)
        opt = unet_train.adamw(plain, 3e-4)
        plain_losses = [float(unet_train.train_step(
            plain, opt, unet_train.bce_loss,
            *unet_train.synth_polar_batch(gen, 8, 512))) for _ in range(3)]
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        meshed, mesh_losses = unet_train.train(steps=3, log_every=1,
                                               mesh=mesh)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    differ = [k for (k, v), w in zip(plain.state_dict().items(),
                                     meshed.state_dict().values())
              if not torch.equal(v, w)]
    log(f"mesh training: 3 train_steps {plain_s:.2f} s, train(mesh="
        f"bone_mesh() of {len(mesh.devices)}, steps=3) {mesh_s:.2f} s; "
        f"losses {plain_losses} / {mesh_losses}; parameters differing: "
        f"{differ} ({smi})")
    if plain_losses != mesh_losses or differ:
        raise AssertionError("mesh training: the one-card mesh differs from "
                             "the one-device train_step")
    dry = unet_train.dryrun(mesh)
    log(f"mesh training: dryrun(bone_mesh()) loss {dry:.6f}")
    if not np.isfinite(dry):
        raise AssertionError("mesh training: dryrun's loss is not finite")

    # ---- sections: the card against the CPU on the same inputs
    reset_launches()
    cpu = torch.device("cpu")
    verts_obb = geom.transform_pts(bones.verts.cpu(),
                                   bones.obb_transform.cpu())
    faces, nbrs = bones.faces.cpu(), bones.neighbors.cpu()
    dev = bones.verts.device
    n_bones = faces.shape[0]
    out = {"raw_loops": 0}
    worst = dict(points_mm=0.0, area_mm2=0.0)
    t0 = time.perf_counter()
    loops = {}
    for frac in (0.3, 0.7):
        z = (bones.z_min + frac * (bones.z_max - bones.z_min)).cpu()
        for select in ("largest", "central"):
            got, want = (slicing.slice_raw(verts_obb.to(d), faces.to(d),
                                           nbrs.to(d), z.to(d),
                                           select=select)
                         for d in (dev, cpu))
            got = slicing.RawLoop(*(x.cpu() for x in got))
            if not torch.equal(got.n, want.n):
                raise AssertionError(f"slice_raw {select} at {frac}: counts "
                                     f"{got.n.tolist()} vs {want.n.tolist()}")
            worst["points_mm"] = max(worst["points_mm"], float(
                (got.points - want.points).abs().max()))
            worst["area_mm2"] = max(worst["area_mm2"], float(
                (got.area - want.area).abs().max()))
            out["raw_loops"] += n_bones
            loops[(frac, select)] = want
    raw_s = time.perf_counter() - t0
    log(f"sections: slice_raw card vs cpu, {out['raw_loops']} loops "
        f"(largest and central, 2 heights, {n_bones} bones, "
        f"{faces.shape[1]} faces each): max |points| "
        f"{worst['points_mm']:.3g} mm, max |area| {worst['area_mm2']:.3g} "
        f"mm^2 ({raw_s:.2f} s both)")
    if worst["points_mm"] > TOL_MM or worst["area_mm2"] > TOL_MM2:
        raise AssertionError("slice_raw: the card differs from the CPU")

    tied = verts_obb.clone()
    tied[..., 2] = torch.round(tied[..., 2] * 2.0) / 2.0
    got, want = (slicing.sorted_geom(tied.to(d), faces.to(d), nbrs.to(d))
                 for d in (dev, cpu))
    differ = [f for f, g, w in zip(slicing.SortedGeom._fields, got, want)
              if not torch.equal(g.cpu(), w)]
    z_min = want.z_mm[..., 0]
    ties = int((z_min[:, 1:] == z_min[:, :-1]).sum())
    log(f"sections: sorted_geom without face_orig, card vs cpu on {n_bones} "
        f"bones with {ties} tied neighbours in the sort: fields differing "
        f"{differ}")
    if differ:
        raise AssertionError(f"sorted_geom: {differ} differ on the card")

    origin, normal = lm.anp_plane_point.cpu(), lm.anp_plane_normal.cpu()
    verts = bones.verts.cpu()
    (gp, gc), (wp, wc) = (slicing.plane_section_points(
        verts.to(d), faces.to(d), origin.to(d), normal.to(d))
        for d in (dev, cpu))
    gp, gc = gp.cpu(), gc.cpu()
    both = gc & wc
    flips = int((gc != wc).sum())
    plane_mm = float((gp - wp).abs()[both].max())
    log(f"sections: plane_section_points through each anatomic-neck plane, "
        f"{int(wc.sum())} crossed faces on the CPU, {flips} crossing "
        f"decisions differ, max |points| {plane_mm:.3g} mm")
    if flips > 2 or plane_mm > TOL_MM:
        raise AssertionError("plane_section_points: the card differs")

    dirs = torch.stack([normal, -normal], dim=1)
    largest = loops[(0.7, "largest")]
    # face_valid: a seeded three quarters of the faces
    valid = torch.rand(faces.shape[:2],
                       generator=torch.Generator().manual_seed(0)) > 0.25
    hits = {}
    for name, fv in (("all faces", None), ("3/4 of the faces", valid)):
        res = [rays.first_hit(verts.to(d)[:, None], faces.to(d)[:, None],
                              origin.to(d)[:, None].expand(-1, 2, -1),
                              dirs.to(d),
                              None if fv is None else fv.to(d)[:, None])
               for d in (dev, cpu)]
        (gpt, _gt, ghit), (wpt, _wt, whit) = (
            [x.cpu() for x in r] for r in res)
        hit_mm = float((gpt - wpt).abs().max())
        hits[name] = int(whit.sum())
        log(f"sections: first_hit along +-normal from each anatomic-neck "
            f"plane point, {name}: {int(whit.sum())} of {whit.numel()} rays "
            f"hit, flags equal {torch.equal(ghit, whit)}, max |point| "
            f"{hit_mm:.3g} mm")
        if not torch.equal(ghit, whit) or hit_mm > TOL_MM:
            raise AssertionError(f"first_hit ({name}): the card differs")

    pts = largest.points
    w = (torch.arange(pts.shape[1]) < largest.n[:, None]).to(torch.float32)
    got, want = (fits.fit_circle(pts.to(d), w.to(d)) for d in (dev, cpu))
    circle_rel = max(float(((g.cpu() - x).abs() / x.abs().clamp(min=1.0))
                           .max()) for g, x in zip(got, want))
    log(f"sections: fit_circle on the {n_bones} largest loops at 0.7, "
        f"radii {np.round(want[2].numpy(), 3).tolist()} mm, card vs cpu "
        f"max relative {circle_rel:.3g}")
    if circle_rel > 1e-4:
        raise AssertionError("fit_circle: the card differs from the CPU")
    if any(launch_counts()):
        raise AssertionError("the sections launched a kernel")
    total_s = time.perf_counter() - t_phase
    log(f"mesh training and sections phase: {total_s:.1f} s in all ({smi})")
    return {"train_s": plain_s, "mesh_train_s": mesh_s, "dryrun_loss": dry,
            "raw_worst": worst, "plane_flips": flips, "plane_mm": plane_mm,
            "hits": hits, "circle_rel": circle_rel, "total_s": total_s}


def main(td):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "needs one card")
    smi = card()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")

    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.io import ingest, native, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, segment, unet
    from shoulder_tpu_torch.ops import kernels, slicing
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import landmarks as L
    from shoulder_tpu_torch.utils import trace

    # ---- build: the kernels (nvcc) and the native ingest (g++) together
    def timed_build(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(timed_build, b)
                  for b in (kernels.build, native.build)]
        (so, so_s), (native_so, native_s) = (b.result() for b in builds)
    log(f"build: {so.name} in {so_s:.2f} s, {native_so.name} in "
        f"{native_s:.2f} s (g++ {' '.join(native.FLAGS)}; host "
        f"{native.host_cpu()})")
    for line in kernels.build_log().splitlines():
        if "ptxas info" in line or "spill" in line:
            log(f"  {line.strip()}")
    lib = kernels.library()
    for name in STACKS:
        band = getattr(DEFAULT_CONFIG, name).band
        log(f"slice-stack shared memory, {name} stack: "
            f"{lib.slice_stack_smem_bytes(band, min(band, DEFAULT_CONFIG.slice_compact_k))}"
            f" B dynamic per block")

    # ---- ingest (host, native) and models
    sides = ["left", "right"] * (BATCH // 2)
    specs, paths, split = [], [], {}
    for i, side in enumerate(sides):
        v, f = synthetic_humerus(side=side,
                                 rng_transform=np.random.default_rng(i))
        paths.append(os.path.join(td, f"bone{i}.stl"))
        stl.write_stl(paths[-1], v, f)
    t0 = time.perf_counter()
    with ingest_split(split):
        specs = [ingest.load_bone(path) for path in paths]
    log(f"ingest: {BATCH} bones in {time.perf_counter() - t0:.3f} s")
    ingest_res = {"host_cpu": native.host_cpu(),
                  "pipeline": ingest_check("pipeline", split, smi,
                                           n_specs=BATCH)}
    ingest_res["pipeline"].update(ingest_both_ways(paths[0], specs[0], smi))
    rf = forest.load_params(dev)
    seg = unet.load_model(dev)
    bones = B.stack_bones(specs, dev)

    # ---- bone 0 alone, a batch of one: its three stacks give phase 3 its
    # real rows, its image and landmarks serve phase 10
    bone0 = B.bone_tensors(specs[0], dev)
    with recording(slicing, "slice_stack", []) as bone0_stacks, \
            recording_raw([]) as bone0_raw, \
            recording(unet, "segment_image", []) as bone0_seg:
        lm_bone0 = L.compute_landmarks(bone0, rf, seg_model=seg)
    torch.cuda.synchronize()
    lm_bone0 = L.Landmarks(*(x.cpu().numpy() for x in lm_bone0))
    bone0_image = bone0_seg[0][0][1][0]
    if len(bone0_stacks) != 3:
        raise AssertionError(f"expected 3 stacks, saw {len(bone0_stacks)}")
    walk = walk_phase(dev, bone0_stacks, smi)

    # ---- pipeline on the card: the main path.  Its first call runs each
    # stage eagerly and captures it (the raw loop's inputs and any plain
    # compaction recorded there); the second replays the graphs, counted
    t0 = time.perf_counter()
    with recording_raw([]) as main_raw, \
            recording(slicing, "_compact_slice", []) as compactions:
        B.compute_landmarks_batch(bones, rf, cfg=DEFAULT_CONFIG,
                                  seg_model=seg)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    replays = trace.counter("graphs.replays")
    reset_launches()
    with recording(slicing, "slice_stack", []) as main_stacks, \
            recording_kw(segment, "sphere_segment", []) as main_sphere:
        lm = B.compute_landmarks_batch(bones, rf, cfg=DEFAULT_CONFIG,
                                       seg_model=seg)
        torch.cuda.synchronize()
    launches, raw_launches, walk_launches = launch_counts()
    score_launches, fit_launches = sphere_launch_counts()
    replays = trace.counter("graphs.replays") - replays
    log(f"pipeline: first batch of {BATCH} in {first_s:.2f} s; the "
        f"replayed batch ({replays} graph replays): {launches} slice-stack "
        f"runs, {raw_launches} raw-loop runs (the batch's surgical-neck "
        f"planes), {walk_launches} walk runs, {score_launches} "
        f"sphere-score and {fit_launches} sphere-fit runs; "
        f"{len(compactions)} plain compactions")
    if not replays:
        raise AssertionError("the main path's second batch replayed no "
                             "CUDA graph")
    if ((score_launches, fit_launches) != sphere_launches(DEFAULT_CONFIG)
            or len(main_sphere) != 1):
        raise AssertionError(f"the main path made {score_launches} sphere "
                             f"score and {fit_launches} sphere fit launches, "
                             f"expected {sphere_launches(DEFAULT_CONFIG)} "
                             f"from one sphere_segment call")
    if launches != 3 or len(main_stacks) != 3:
        raise AssertionError(f"the main path made {launches} slice-stack "
                             f"launches, expected 3 for the batch")
    if raw_launches != 1 or len(main_raw) != 1:
        raise AssertionError(f"the main path made {raw_launches} raw-loop "
                             f"launches, expected 1 for the batch")
    if walk_launches != 0 or compactions:
        raise AssertionError("the main path ran the standalone walk or a "
                             "plain compaction")

    lm_np = L.Landmarks(*(x.cpu().numpy() for x in lm))
    for name, arr in lm_np._asdict().items():
        if arr.shape[0] != BATCH:
            raise AssertionError(f"{name}: shape {arr.shape}")
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise AssertionError(f"{name}: non-finite values")
    for i, side in enumerate(sides):
        got_left = bool(lm_np.side_is_left[i])
        ns, rv, rad = (float(lm_np.neckshaft[i]), float(lm_np.retroversion[i]),
                       float(lm_np.radius_curvature[i]))
        log(f"bone {i} ({side}): side {'left' if got_left else 'right'}, "
            f"neck-shaft {ns:.3f}, retroversion {rv:.3f}, radius {rad:.3f}, "
            f"overflow {bool(lm_np.qc_slice_overflow[i])}, "
            f"open edges {bool(lm_np.qc_open_edges[i])}")
        ok = (got_left == (side == "left")
              and abs(ns - TRUTH["neck_shaft_deg"]) < 3.0
              and abs(rv - TRUTH["retroversion_deg"]) < 3.0
              and abs(rad - TRUTH["head_radius"]) < 1.0
              and not lm_np.qc_slice_overflow[i])
        if not ok:
            raise AssertionError(f"bone {i} failed the anatomy gate")

    # one bone on the CPU (plain composition) against the card
    t0 = time.perf_counter()
    with recording(slicing, "slice_stack", []) as cpu_stacks:
        cpu = L.compute_landmarks(B.bone_tensors(specs[0], "cpu"),
                                  forest.load_params("cpu"),
                                  seg_model=unet.load_model("cpu"))
    # the card's sums run in another order, so contours differ by ulps; a
    # largest-loop flip on a near-tie would show as a slice whose area
    # jumps.  Reported, not gated.
    for name, (_, g), (_, c) in zip(STACKS, bone0_stacks, cpu_stacks):
        g = slicing.SliceStack(*(x.cpu() for x in g))
        dz = float((g.zs - c.zs).abs().max())
        dc = float((g.contours - c.contours).abs().max())
        da = (g.areas - c.areas).abs()
        log(f"card vs cpu, {name} stack: max |dz| {dz:.3g}, max |contour| "
            f"{dc:.3g} mm, max |area| {float(da.max()):.3g} mm^2, slices "
            f"with |area| diff > 0.01: {int((da > 0.01).sum())}")
    log(f"cpu reference bone 0 in {time.perf_counter() - t0:.1f} s: "
        f"neck-shaft {float(cpu.neckshaft):.3f}, retroversion "
        f"{float(cpu.retroversion):.3f}, radius "
        f"{float(cpu.radius_curvature):.3f}")
    if bool(cpu.side_is_left) != bool(lm_np.side_is_left[0]):
        raise AssertionError("cpu and card disagree on side")
    for name in ("neckshaft", "retroversion", "radius_curvature"):
        diff = abs(float(getattr(cpu, name)) - float(getattr(lm_np, name)[0]))
        if not diff < 0.75:
            raise AssertionError(f"cpu and card differ by {diff} in {name}")

    # ---- the fused kernel against its per-bone launches and the plain
    # composition
    worst, per_stack, per_stack_bone0 = slice_kernel_phase(
        main_stacks, bone0_stacks, smi)
    del main_stacks
    # ---- the raw-loop kernel against its plain version
    raw_worst, raw_time = raw_loop_phase(main_raw[0], bone0_raw[0], smi)
    del main_raw, bone0_raw
    # ---- the sphere kernels against their plain versions
    sphere_res = sphere_phase(main_sphere[0], smi)
    del main_sphere

    # ---- timing: a batch of 1 against a batch of 8, the stages eager;
    # each also with the plain raw loop the parent tree ran on the card
    # (profiled and counted), and both timed in interleaved turns; then
    # each replayed as CUDA graphs, beside its eager numbers
    t_phase6 = time.perf_counter()
    timing, timing_eager, timing_plain = {}, {}, {}
    for n in (1, BATCH):
        batch_n = B.stack_bones(specs[:n], dev)
        timing_eager[n] = batch_timing(batch_n, rf, seg, smi, eager=True)
        timing[n] = graphs_timing(batch_n, rf, seg, timing_eager[n], smi)
        with swapped(slicing, "slice_raw_banded", plain_raw_banded):
            timing_plain[n] = batch_timing(batch_n, rf, seg, smi, reps=0,
                                           eager=True)
        ab = ab_timing(batch_n, rf, seg)
        eager = timing_eager[n]
        eager["ab_ms"], timing_plain[n]["ab_ms"] = ab["kernel"], ab["plain"]
        p, k = (float(np.median(ab[v])) for v in ("plain", "kernel"))
        log(f"batch of {n}, stages eager, plain raw loop -> raw-loop "
            f"kernel: launches "
            f"{timing_plain[n]['launches']} -> {eager['launches']}, "
            f"synchronizing calls {timing_plain[n]['syncs']} -> "
            f"{eager['syncs']}, device busy {timing_plain[n]['busy_ms']:.1f}"
            f" -> {eager['busy_ms']:.1f} ms, idle share "
            f"{timing_plain[n]['idle_share']:.3f} -> "
            f"{eager['idle_share']:.3f}; interleaved batch ms, median "
            f"(min-max) over {len(ab['kernel'])} each: {p:.1f} "
            f"({min(ab['plain']):.1f}-{max(ab['plain']):.1f}) -> {k:.1f} "
            f"({min(ab['kernel']):.1f}-{max(ab['kernel']):.1f}) ({smi})")
        if eager["syncs"] > timing_plain[n]["syncs"]:
            raise AssertionError("the raw-loop kernel added synchronizing "
                                 "calls")
    log(f"timing phase: {time.perf_counter() - t_phase6:.1f} s")
    one, full = timing[1], timing[BATCH]
    log(f"throughput: {BATCH / full['p50_ms'] * 1e3:.3f} bones/s, p50 "
        f"{full['p50_ms']:.1f} ms/batch of {BATCH}; launches per batch of "
        f"{BATCH} / of 1: {full['launches']} / {one['launches']} "
        f"({full['launches'] / one['launches']:.3f}x), synchronizing calls "
        f"{full['syncs']} / {one['syncs']} ({smi})")
    # memory: the batch's peak grows with its bones; the largest batch
    # that fits the card, linear in B from the batches of 1 and of 8
    per_bone = (full["peak_bytes"] - one["peak_bytes"]) / (BATCH - 1)
    total = torch.cuda.get_device_properties(0).total_memory
    fits_b = 1 + int((total - full["resident_bytes"] - one["peak_bytes"])
                     // max(per_bone, 1.0))
    log(f"memory: peak {one['peak_bytes'] / 2**20:.1f} / "
        f"{full['peak_bytes'] / 2**20:.1f} MiB for a batch of 1 / {BATCH}, "
        f"{per_bone / 2**20:.1f} MiB per bone; the {total / 2**30:.1f} GiB "
        f"card holds a batch of about {fits_b} ({smi})")
    if full["launches"] > 1.25 * one["launches"] \
            or full["syncs"] > one["syncs"]:
        raise AssertionError("a batch of 8 takes more launches or syncs "
                             "than the batch fold allows")
    if full["syncs"] > 3:
        raise AssertionError(f"a batch of {BATCH} makes {full['syncs']} "
                             f"synchronizing calls, more than 3")

    with ingest_split(split := {}):
        facade = facade_phase(td, paths[0], dev, lm_np, smi)
    ingest_res["facade"] = ingest_check("facade", split, smi, n_specs=3)
    with ingest_split(split := {}):
        cohort_launches, cohort_res = cohort_phase(paths, dev, lm_np, sides,
                                                   smi)
    ingest_res["cohort"] = ingest_check("cohort", split, smi, n_specs=BATCH)
    ct_res = ct_phase(dev, rf, seg, smi)
    ct_worst, ct_raw_worst = ct_res["worst"], ct_res["raw_worst"]
    ingest_res["ct"] = ct_res["ingest"]
    train_res = train_phase(td, dev, rf, bone0, bone0_image, lm_bone0, smi)
    train_worst = train_res["worst"]
    ingest_res["corpus"] = train_res["ingest"]
    acc = accuracy_phase(dev, rf, seg, smi)
    ingest_res["accuracy"] = {name: acc[name]["ingest"]
                              for name in ("healthy", "arthritic")}
    with ingest_split(split := {}):
        mesh_res = mesh_phase(bones, lm, paths, cohort_res, smi)
    ingest_res["mesh"] = ingest_check("mesh", split, smi, n_specs=BATCH)
    sections = mesh_train_sections_phase(bones, lm, smi)
    robust = robustness_phase(td, dev, rf, seg, acc, bones, lm, smi)
    ingest_res["robustness"] = robust.pop("ingest")
    bench_res = bench_phase(full, bones, rf, seg, smi)
    ingest_res["bench"] = bench_res.pop("ingest")
    evidence = evidence_phase(dev, rf, seg, acc, smi)
    ingest_res["evidence"] = evidence.pop("ingest")

    print(json.dumps({"ingest": ingest_res,
                      "mesh_train_sections": sections, "accuracy": {
        name: {key: acc[name][key] for key in
               ("max_abs_err", "mean_err", "max_abs_vs_jax", "vs_jax",
                "ingest_s", "batch_s")}
        for name in ("healthy", "arthritic")}}))
    print(json.dumps({"robustness": robust}))
    print(json.dumps({"bench": bench_res}))
    print(json.dumps({"evidence": evidence}))

    prox = per_stack["proximal"]
    print(json.dumps({"kernels": [{
        "name": "slice_stack",
        "route": "cuda",
        "source": "shoulder_tpu_torch/csrc/slice_stack.cu",
        "replaces": "shoulder_tpu/ops/pallas_chain.py:52",
        "launches": launches,
        "launches_per_phase": {"pipeline": launches,
                               "facade": {key: v[0] for key, v in
                                          facade.items() if key != "walk"},
                               "cohort": cohort_launches[0],
                               "ct": ct_res["launches"],
                               "corpus": train_res["launches"],
                               "mesh": mesh_res["launches"],
                               "robustness": {
                                   key: v[0] for key, v in
                                   robust["launches"].items()},
                               "bench": {
                                   key: v[0] for key, v in
                                   bench_res["launches"].items()},
                               "evidence": {
                                   key: v[0] for key, v in
                                   evidence["launches"].items()}},
        "max_abs_err": max(w[key] for w in (worst, ct_worst, train_worst)
                           for key in ("contour_mm", "centroid_mm")),
        "max_area_err_mm2": max(w[key]
                                for w in (worst, ct_worst, train_worst)
                                for key in ("area_mm2", "total_area_mm2")),
        "rows_compared": (worst["rows"] + ct_worst["rows"]
                          + train_worst["rows"]),
        "rows_best_loop_differs": (worst["loop_differs"]
                                   + ct_worst["loop_differs"]
                                   + train_worst["loop_differs"]),
        "walk_rows_compared": worst["walk_rows"] + ct_worst["walk_rows"],
        "walk_disagreement": max(worst["walk_err"], ct_worst["walk_err"]),
        "ms": prox["ms"],
        "plain_ms": prox["plain_ms"],
        "bound_ms": prox["bound_ms"],
        "bound_by": prox["bound_by"],
        "library_ms": None,
        "batch": BATCH,
        "per_stack": per_stack,
        "per_stack_bone0": per_stack_bone0,
        "per_stack_ct": ct_res["per_stack"],
        "timing": timing,
        "timing_eager": timing_eager,
        "timing_plain_raw_loop": timing_plain,
        "mesh": mesh_res,
        "ct": {"max_abs_err": max(ct_worst["contour_mm"],
                                  ct_worst["centroid_mm"]),
               "max_area_err_mm2": max(ct_worst["area_mm2"],
                                       ct_worst["total_area_mm2"]),
               "rows_compared": ct_worst["rows"],
               "rows_best_loop_differs": ct_worst["loop_differs"],
               "per_volume": ct_res["per_volume"],
               "unet_gflop": ct_res["unet_gflop"],
               "unet_bound_ms": ct_res["unet_bound_ms"],
               "unet_bound_by": ct_res["unet_bound_by"],
               "batch_ms": ct_res["batch_ms"],
               "phase_s": ct_res["total_s"]},
        "training": {key: train_res[key] for key in
                     ("bones", "extract_s_per_bone", "unet_step",
                      "ct_unet_step", "unet_losses", "ct_losses",
                      "card_vs_cpu_gradient", "total_s")},
    }, {
        "name": "slice_raw",
        "route": "cuda",
        "source": "shoulder_tpu_torch/csrc/slice_raw.cu",
        "replaces": "shoulder_tpu/ops/slicing.py:937",
        "replaces_kind": "XLA code (slice_raw_banded), no TPU kernel",
        "launches": raw_launches,
        "launches_per_phase": {"pipeline": raw_launches,
                               "facade": {key: v[1] for key, v in
                                          facade.items() if key != "walk"},
                               "cohort": cohort_launches[1],
                               "ct": ct_res["raw_launches"],
                               "corpus": 0,
                               "mesh": mesh_res["raw_launches"],
                               "robustness": {
                                   key: v[1] for key, v in
                                   robust["launches"].items()},
                               "bench": {
                                   key: v[1] for key, v in
                                   bench_res["launches"].items()},
                               "evidence": {
                                   key: v[1] for key, v in
                                   evidence["launches"].items()}},
        "max_abs_err": max(w[key] for w in (raw_worst, ct_raw_worst)
                           for key in ("points_mm", "centroid_mm")),
        "max_area_err_mm2": max(raw_worst["area_mm2"],
                                ct_raw_worst["area_mm2"]),
        "points_bit_equal": (raw_worst["points_equal"]
                             and ct_raw_worst["points_equal"]),
        "planes_compared": raw_worst["planes"] + ct_raw_worst["planes"],
        "planes_loop_differs": (raw_worst["loop_differs"]
                                + ct_raw_worst["loop_differs"]),
        "ms": raw_time["ms"],
        "plain_ms": raw_time["plain_ms"],
        "bound_ms": raw_time["bound_ms"],
        "bound_by": raw_time["bound_by"],
        "library_ms": None,
        "batch": raw_time,
        "ct": ct_res["raw_time"],
    }, {
        "name": "sphere_score",
        "route": "cuda",
        "source": "shoulder_tpu_torch/csrc/sphere_score.cu",
        "replaces": "shoulder_tpu/models/segment.py:174",
        "replaces_kind": "XLA code (sphere_segment), no TPU kernel",
        "launches": score_launches,
        "max_abs_err": sphere_res["scores"]["max_abs_err"],
        "max_rel_err": sphere_res["scores"]["max_rel_err"],
        "picks_compared": sphere_res["scores"]["picks"],
        "ties": sphere_res["scores"]["ties"],
        "ms": sphere_res["time"]["batch"]["score"]["ms"],
        "plain_ms": sphere_res["time"]["batch"]["score"]["plain_ms"],
        "bound_ms": sphere_res["time"]["batch"]["score"]["bound_ms"],
        "bound_by": sphere_res["time"]["batch"]["score"]["bound_by"],
        "library_ms": None,
        "bone0": sphere_res["time"]["bone0"]["score"],
    }, {
        "name": "sphere_fit",
        "route": "cuda",
        "source": "shoulder_tpu_torch/csrc/sphere_fit.cu",
        "replaces": "shoulder_tpu/models/segment.py:145",
        "replaces_kind": "XLA code (sphere_segment), no TPU kernel",
        "launches": fit_launches,
        "max_abs_err": max(sphere_res["fits"]["fit_moments"]["max_sphere_mm"],
                           sphere_res["fits"]["irls_moments"]["max_sphere_mm"],
                           sphere_res["fits"]["sigma_sums"]["max_sigma_mm"]),
        "fits": sphere_res["fits"],
        "ms": sphere_res["time"]["batch"]["fit_irls"]["ms"],
        "plain_ms": sphere_res["time"]["batch"]["fit_irls"]["plain_ms"],
        "bound_ms": sphere_res["time"]["batch"]["fit_irls"]["bound_ms"],
        "bound_by": sphere_res["time"]["batch"]["fit_irls"]["bound_by"],
        "library_ms": sphere_res["time"]["batch"]["fit_irls"]["library_ms"],
        "given": sphere_res["time"]["batch"]["fit_given"],
        "sigma": sphere_res["time"]["batch"]["sigma"],
        "bone0": {key: sphere_res["time"]["bone0"][key]
                  for key in ("fit_given", "fit_irls", "sigma")},
        "segment_vs_plain": sphere_res["vs_plain"],
        "segment_alone_vs_batch": sphere_res["alone_vs_batch"],
        "bones_bit_equal_alone": sphere_res["bones_bit_equal_alone"],
        "kernel_launches_compared": sphere_res["kernel_launches_compared"],
    }, {
        "name": "chain_walk",
        "route": "cuda",
        "source": "shoulder_tpu_torch/csrc/chain_walk.cu",
        "replaces": "shoulder_tpu/ops/pallas_chain.py:52",
        "launches": walk_launches,
        "max_abs_err": walk["max_abs_err"],
        "ms": walk["ms"],
        "plain_ms": walk["plain_ms"],
        "bound_ms": walk["bound_ms"],
        "bound_by": walk["bound_by"],
        "library_ms": None,
        "batch8_ms": walk["batch8_ms"],
        "batch8_plain_ms": walk["batch8_plain_ms"],
        "batch8_bound_ms": walk["batch8_bound_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        main(tmp)
