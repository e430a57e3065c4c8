"""Run the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: a CUDA card must be present (there is no CPU fallback);
  2. build: compile the contour-chain walk kernel from csrc/ with nvcc;
  3. kernel vs plain: the walk kernel against its plain PyTorch version on
     random loop rows, an empty slice, and the real (succ, crossed) rows of
     all three slice stacks of one bone at DEFAULT_CONFIG: exact equality
     of n, is_start and order[:n]; both timed at the main path's shapes;
  4. pipeline: ingest 8 synthetic humeri (4 left, 4 right) with the port's
     own ingest and run compute_landmarks_batch at DEFAULT_CONFIG with the
     UNet segmenter on the card; every bone must get its side right and
     land within 3 deg / 3 deg / 1 mm of the constructed neck-shaft
     angle, retroversion and head radius, with no slice overflow, and the
     walk kernel must have been launched; one bone runs again on the CPU
     (plain walk) and must agree within 0.75 deg / 0.75 mm, bench.py's gate;
  5. timing: 5 warm batches of 8, synchronized;
  6. facade: the README flow through shoulder_tpu_torch.Humerus on the card
     (canal on z through the origin, metrics equal to phase 4's bone 0
     within 0.05 deg / 0.05 mm), the osteotomy probes, a plot, the three
     slice views, and a ProximalHumerus checked against the same bone on
     the CPU; the walk kernel must run in each of these paths;
  7. cohort: process_cohort over the 8 STLs in batches of 4 (two batches,
     one prefetch); each bone equal to phase 4 within 0.05 deg / 0.05 mm.

The bone STLs live in one temporary directory for the whole run.

The last three lines: a JSON object describing each kernel (launches in
the main path's run, disagreement with the plain version, times), the
card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

BATCH = 8
REPS = 5
TRUTH = dict(neck_shaft_deg=135.0, retroversion_deg=25.0, head_radius=24.0)


def log(msg):
    print(msg, flush=True)


def timed_cuda(fn, reps):
    """Mean ms per call of fn() over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


@contextlib.contextmanager
def recording(module, name, sink):
    """Within the block, module.name runs as usual and each call's
    (args, result) is appended to sink."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        sink.append((args, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield sink
    finally:
        setattr(module, name, fn)


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
    """Phase 6: the README flow through the public API on the card."""
    import shoulder_tpu_torch as stt
    from shoulder_tpu_torch.io import stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.ops import chain_walk

    counts = {}
    chain_walk.launch_count = 0
    t0 = time.perf_counter()
    hum = stt.Humerus(path, device=dev)
    ingest_s = time.perf_counter() - t0
    hum.apply_csys_canal_transepiconylar()
    first_s = time.perf_counter() - t0
    counts["landmarks"] = chain_walk.launch_count
    log(f"facade: Humerus first landmark in {first_s * 1e3:.1f} ms wall "
        f"(ingest {ingest_s * 1e3:.1f} ms, landmarks and csys "
        f"{(first_s - ingest_s) * 1e3:.1f} ms), "
        f"{counts['landmarks']} walk launches ({smi})")

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

    # the slice views: one walk launch each
    before = chain_walk.launch_count
    for name in ("full_slices", "proximal_slices", "distal_slices"):
        view = getattr(hum, name)
        xy, areas = view.ixy((0.1, 0.9)), view.areas1((0.1, 0.9))
        log(f"view {name}: contours {xy.shape}, areas "
            f"{areas.min():.1f}..{areas.max():.1f} mm^2")
        if not (np.isfinite(xy).all() and (areas > 0).all()):
            raise AssertionError(f"{name}: non-finite contour or empty slice")
    counts["views"] = chain_walk.launch_count - before

    # a proximal-only bone, on the card and on the CPU (plain walk)
    v, f = synthetic_humerus(side="left", proximal_only=True,
                             rng_transform=np.random.default_rng(8))
    prox_path = os.path.join(td, "proximal.stl")
    stl.write_stl(prox_path, v, f)
    before = chain_walk.launch_count
    ph = stt.ProximalHumerus(prox_path, device=dev)
    card = (ph.side(), ph.neckshaft(), ph.radius_curvature())
    counts["proximal"] = chain_walk.launch_count - before
    ph_cpu = stt.ProximalHumerus(prox_path, device="cpu")
    cpu = (ph_cpu.side(), ph_cpu.neckshaft(), ph_cpu.radius_curvature())
    log(f"ProximalHumerus: card {card}, cpu {cpu}")
    if card[0] != "left" or cpu[0] != "left":
        raise AssertionError("ProximalHumerus got the side wrong")
    if not (abs(card[1] - cpu[1]) < 0.75 and abs(card[2] - cpu[2]) < 0.75):
        raise AssertionError("ProximalHumerus card and cpu differ")

    log(f"facade walk launches: {counts}")
    for name, least in (("landmarks", 3), ("views", 3), ("proximal", 2)):
        if counts[name] < least:
            raise AssertionError(f"facade {name}: {counts[name]} walk "
                                 f"launches, expected at least {least}")
    return counts


def cohort_phase(paths, dev, lm_np, sides, smi):
    """Phase 7: process_cohort over the STLs, ingest included."""
    from shoulder_tpu_torch import cohort
    from shoulder_tpu_torch.ops import chain_walk

    chain_walk.launch_count = 0
    t0 = time.perf_counter()
    res = cohort.process_cohort(paths, device=dev, batch_size=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chain_walk.launch_count
    log(f"cohort: {len(res)} bones in {wall:.2f} s, "
        f"{len(res) / wall:.3f} bones/s with ingest, batch 4, "
        f"{launches} walk launches ({smi})")
    if len(res) != len(paths) or launches == 0:
        raise AssertionError("cohort lost bones or never launched the walk")
    for i, r in enumerate(res):
        got = (r["side"], r["neckshaft_deg"], r["retroversion_deg"],
               r["radius_curvature_mm"])
        if r["side"] != sides[i]:
            raise AssertionError(f"cohort bone {i}: side {r['side']}")
        gate_like(f"cohort bone {i}", got, phase4_bone(lm_np, i))
    summary = cohort.cohort_summary(res)
    log(f"cohort summary: {summary}")
    return launches


def main(td):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "needs one card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")

    from shoulder_tpu_torch.config import DEFAULT_CONFIG
    from shoulder_tpu_torch.io import ingest, stl
    from shoulder_tpu_torch.io.testdata import synthetic_humerus
    from shoulder_tpu_torch.models import forest, unet
    from shoulder_tpu_torch.ops import chain_walk, slicing
    from shoulder_tpu_torch.pipeline import batch as B
    from shoulder_tpu_torch.pipeline import landmarks as L

    # ---- build
    t0 = time.perf_counter()
    so = chain_walk.build()
    log(f"build: {so.name} in {time.perf_counter() - t0:.2f} s")

    # ---- ingest (host) and models
    sides = ["left", "right"] * (BATCH // 2)
    specs, paths = [], []
    t0 = time.perf_counter()
    for i, side in enumerate(sides):
        v, f = synthetic_humerus(side=side,
                                 rng_transform=np.random.default_rng(i))
        paths.append(os.path.join(td, f"bone{i}.stl"))
        stl.write_stl(paths[-1], v, f)
        specs.append(ingest.load_bone(paths[-1]))
    log(f"ingest: {BATCH} bones in {time.perf_counter() - t0:.1f} s")
    rf = forest.load_params(dev)
    seg = unet.load_model(dev)
    bones = B.stack_bones(specs, dev)

    # ---- kernel vs plain: record the real walk rows of one bone's stacks
    kernel_walk = chain_walk.chain_walk_marked
    with recording(chain_walk, "chain_walk_marked", []) as walks, \
            recording(slicing, "slice_stack", []) as card_stacks:
        L.compute_landmarks(B.bone_tensors(specs[0], dev), rf,
                            seg_model=seg)
    if len(walks) != 3:
        raise AssertionError(f"expected 3 stack walks, saw {len(walks)}")
    recorded = [args for args, _ in walks]

    k = min(DEFAULT_CONFIG.slice_compact_k, DEFAULT_CONFIG.proximal.band)
    rng = np.random.default_rng(0)
    cases = {"random": random_walk_rows(rng, k, 64),
             "empty": (np.tile(np.arange(64, dtype=np.int32), (8, 1)),
                       np.zeros((8, 64), np.int32))}
    cases = {name: tuple(torch.as_tensor(a, device=dev) for a in c)
             for name, c in cases.items()}
    for name, (succ, crossed) in zip(("full", "proximal", "distal"), recorded):
        cases[name] = (succ, crossed)
    max_err = 0
    for name, (succ, crossed) in cases.items():
        got = kernel_walk(succ, crossed)
        torch.cuda.synchronize()
        want = chain_walk.chain_walk_plain(succ, crossed)
        err = walk_disagreement(got, want)
        log(f"walk {name}: rows {succ.shape[0]} x {succ.shape[1]}, "
            f"visits {int(want[1].sum())}, max disagreement {err}")
        if err != 0:
            raise AssertionError(f"walk kernel disagrees on {name}")
        max_err = max(max_err, err)
    if int(kernel_walk(*cases["empty"])[1].max()) != 0:
        raise AssertionError("the empty slice visited faces")

    # main-path shapes: the proximal stack (600 x 384) for one bone and
    # for a batch of 8 bones folded into rows
    prox = cases["proximal"]
    prox8 = tuple(x.repeat(BATCH, 1).contiguous() for x in prox)
    kernel_ms = timed_cuda(lambda: kernel_walk(*prox), 50)
    plain_ms = timed_cuda(lambda: chain_walk.chain_walk_plain(*prox), 3)
    kernel8_ms = timed_cuda(lambda: kernel_walk(*prox8), 50)
    plain8_ms = timed_cuda(lambda: chain_walk.chain_walk_plain(*prox8), 3)
    log(f"walk time, proximal stack {tuple(prox[0].shape)}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.2f} ms")
    log(f"walk time, batch-8 rows {tuple(prox8[0].shape)}: kernel "
        f"{kernel8_ms:.4f} ms, plain {plain8_ms:.2f} ms")

    # ---- pipeline on the card, through the kernel
    chain_walk.launch_count = 0
    t0 = time.perf_counter()
    lm = B.compute_landmarks_batch(bones, rf, cfg=DEFAULT_CONFIG,
                                   seg_model=seg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = chain_walk.launch_count
    log(f"pipeline: first batch of {BATCH} in {first_s:.2f} s, "
        f"{launches} walk launches")
    if launches == 0:
        raise AssertionError("the main path never launched the walk kernel")

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

    # one bone on the CPU (plain walk) against the card
    t0 = time.perf_counter()
    with recording(slicing, "slice_stack", []) as cpu_stacks:
        cpu = L.compute_landmarks(B.bone_tensors(specs[0], "cpu"),
                                  forest.load_params("cpu"),
                                  seg_model=unet.load_model("cpu"))
    # float sums run in another order on the card (parallel cumsum,
    # atomics), so contours differ by ulps; a largest-loop flip on a
    # near-tie would show as a slice whose area jumps.  Reported, not gated.
    for name, (_, g), (_, c) in zip(("full", "proximal", "distal"),
                                    card_stacks, cpu_stacks):
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

    # ---- timing
    lat = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        B.compute_landmarks_batch(bones, rf, cfg=DEFAULT_CONFIG,
                                  seg_model=seg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    p50 = float(np.median(lat))
    log("batch ms: " + ", ".join(f"{t * 1e3:.1f}" for t in lat))
    log(f"throughput: {BATCH / p50:.3f} bones/s, p50 {p50 * 1e3:.1f} "
        f"ms/batch of {BATCH} ({smi})")

    facade_launches = facade_phase(td, paths[0], dev, lm_np, smi)
    cohort_launches = cohort_phase(paths, dev, lm_np, sides, smi)

    print(json.dumps({"kernels": [{
        "name": "chain_walk",
        "route": "cuda",
        "source": "shoulder_tpu_torch/csrc/chain_walk.cu",
        "replaces": "shoulder_tpu/ops/pallas_chain.py:52",
        "launches": launches,
        "launches_per_phase": {"pipeline": launches,
                               "facade": facade_launches,
                               "cohort": cohort_launches},
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
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
