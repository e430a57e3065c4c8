"""Procedural synthetic humerus meshes: a frozen copy of the port's
io/testdata.py (`synthetic_humerus`, `truth_geometry`), so that a later
change to the port's generator does not move the benchmark's inputs.

Generates watertight, humerus-like generalized cylinders so the full
pipeline (and CI) runs without any external STL fixtures.  The shape models
the anatomy the landmark detectors key on: a long shaft, an offset spherical
head tilted by (inclination, retroversion), a bicipital groove notch, and
flared epicondyles distally.
"""

from __future__ import annotations

import numpy as np


def _smoothstep(x, lo, hi):
    t = np.clip((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def truth_geometry(
    length: float = 300.0,
    head_radius: float = 24.0,
    neck_shaft_deg: float = 135.0,
    retroversion_deg: float = 25.0,
    side: str = "left",
    **_ignored,
):
    """The exact constructed-anatomy quantities synthetic_humerus realizes.

    Returns a dict with the articular plane normal `n_true` (build frame),
    sphere center `head_c`, plane offset `cap_h` (plane point =
    head_c + cap_h * n_true), and the ring-grid top `z_top` (the grid
    spans [z0, z_top], NOT [z0, length]).  Accepts and ignores extra
    generator kwargs so a params dict can be splatted directly.
    """
    incl = np.deg2rad(180.0 - neck_shaft_deg)
    retro = np.deg2rad(retroversion_deg)
    sign = 1.0 if side == "left" else -1.0
    # azimuth convention measured against the pipeline/reference
    # retroversion formula (bone_props.py:64-85): an articular-plane
    # normal at azimuth (180 - retro) from the +x transepicondylar axis
    # reads back as exactly `retro` degrees of retroversion.
    phi_h = sign * (np.pi - retro)
    n_true = np.array(
        [
            np.sin(incl) * np.cos(phi_h),
            np.sin(incl) * np.sin(phi_h),
            np.cos(incl),
        ]
    )
    head_c = np.array([0.0, 0.0, length - 1.05 * head_radius]) \
        + 0.45 * head_radius * n_true
    z_top = head_c[2] + 0.97 * np.sqrt(
        max(head_radius**2 - head_c[0] ** 2 - head_c[1] ** 2, 1.0)
    )
    return dict(
        n_true=n_true, head_c=head_c, cap_h=0.10 * head_radius,
        z_top=z_top, sign=sign, phi_h=phi_h,
    )


def synthetic_humerus(
    length: float = 300.0,
    shaft_radius: float = 11.0,
    head_radius: float = 24.0,
    neck_shaft_deg: float = 135.0,
    retroversion_deg: float = 25.0,
    groove_theta_deg: float | None = None,
    groove_depth: float = 3.5,
    groove_width_deg: float = 16.0,
    epicondyle_half_width: float = 30.0,
    metaphysis_scale: float = 0.85,   # tuberosity flare as head_radius frac
    n_rings: int = 160,
    n_theta: int = 128,
    side: str = "left",
    rng_transform: np.random.Generator | None = None,
    proximal_only: bool = False,
    # arthritic deformations (BASELINE config 4 stress case)
    head_flattening: float = 0.0,     # 0..~0.3: flattens the articular dome
    osteophyte_amp: float = 0.0,      # mm: marginal osteophyte ridge height
    surface_noise: float = 0.0,       # mm: rough cartilage loss
    return_head_label: bool = False,
):
    """Returns (vertices (V,3), faces (F,3)) of a watertight synthetic bone.

    Canonical build frame: z in [0, length], head at high z.  If
    `rng_transform` is given, a random rigid transform is applied to mimic an
    arbitrary CT frame.

    The parameters are REALIZED exactly, not just suggested: the articular
    surface is a spherical cap of radius `head_radius` cut by a plane whose
    normal is the parametric head axis (built from neck_shaft_deg /
    retroversion_deg / side), with a sharp anatomic-neck crease at the cap
    rim.  A plane fit to the cap boundary therefore recovers the
    construction parameters — this is the ground-truth contract
    tests/test_accuracy_gate.py freezes.

    `groove_theta_deg=None` (default) places the bicipital groove at its
    anatomical azimuth relative to the head axis (140 deg anterior of the
    head azimuth, side-mirrored — measured on the reference fixtures); the
    groove is what side detection keys on (reference bone_props.py:24-48),
    so an uncoupled groove makes `side` undefined.
    Pass an explicit value only to build deliberately non-anatomical bones.

    With `return_head_label`, also returns a per-vertex bool marking
    vertices on the articular cap — exact generative supervision for the
    articular-surface segmenter (labels survive the arthritic
    deformations: a flattened dome is still articular, which is precisely
    where a fit-residual label would lie).
    """
    z0 = 0.55 * length if proximal_only else 0.0
    thetas = np.linspace(-np.pi, np.pi, n_theta, endpoint=False)

    # parametric head axis: the articular cap's plane normal.  NS angle is
    # the inclination from the (downward) canal axis, retroversion the
    # azimuth relative to the transepicondylar (x) axis, mirrored by side.
    tg = truth_geometry(
        length, head_radius, neck_shaft_deg, retroversion_deg, side
    )
    n_true, head_c = tg["n_true"], tg["head_c"]
    sign, phi_h = tg["sign"], tg["phi_h"]
    if groove_theta_deg is None:
        # anatomical intertubercular sulcus: ~140 deg anterior of the head
        # azimuth about the canal (side detection keys on the SIGN of this
        # relation, reference bone_props.py:24-48).  Offset measured on the
        # reference's real fixtures: signed head->groove angle about
        # canal-down is -138 deg (humerus_left) / +147 deg (humerus_right)
        # — the head points posteromedially while the groove is
        # anterolateral, nearly opposite azimuths, NOT the 35 deg a naive
        # reading suggests.  head azimuth = 180 - retro, so groove =
        # (180 - retro) + 140 pre-sign; the side mirror below flips it.
        groove_theta_deg = 320.0 - retroversion_deg

    # ring grid extends to just below where the canal axis exits the head
    # sphere, so the dome top is genuinely spherical (a flat truncation
    # would hand the articular detectors a non-spherical "articular" top);
    # the cap face closes the last ring onto the sphere's topmost point.
    zs = np.linspace(z0, tg["z_top"], n_rings)
    tt, zz = np.meshgrid(thetas, zs)

    # radius field r(z, theta): the shaft tapers out under the head so it
    # cannot poke a cylinder through the dome (the metaphysis + sphere own
    # the surface above 0.88 L)
    r = shaft_radius * (1.0 - _smoothstep(zz, 0.88 * length, 0.94 * length))

    # distal flare (epicondyles): ellipse in x
    flare = 1.0 - _smoothstep(zz, 0.02 * length, 0.18 * length)
    ex = shaft_radius + (epicondyle_half_width - shaft_radius) * flare
    ey = shaft_radius * (1.0 + 0.3 * flare)
    r_dist = (ex * ey) / np.sqrt(
        (ey * np.cos(tt)) ** 2 + (ex * np.sin(tt)) ** 2
    )
    r = np.maximum(r, r_dist)

    # metaphysis: smooth flare from the shaft toward the tuberosity region
    # below the head.  The shaft->tuberosity rise IS the surgical neck; on
    # a real humerus it sits at ~0.78-0.82L, inside the changepoint's
    # top-30% search window (config surgical_neck_cutoff_full).  Placing it
    # lower makes the strongest area shift in the window the dome rise
    # instead, and the detected "neck" lands at the anatomic-neck rim.
    if metaphysis_scale > 0:
        # rise at the surgical neck (L-relative, anchors the changepoint);
        # fade relative to the HEAD so the tuberosity tops always stop
        # short of the anatomic-neck rim and the rim crease stays exposed
        # whatever the head-to-length ratio is
        meta_frac = _smoothstep(zz, 0.74 * length, 0.82 * length) * (
            1.0 - _smoothstep(
                zz,
                head_c[2] - 0.85 * head_radius,
                head_c[2] - 0.30 * head_radius,
            )
        )
        # real tuberosities are lobed, not a body of revolution: greater
        # and lesser tuberosity bulges astride the groove, a narrow calcar
        # under the head.  An axisymmetric collar here is a sphere-sized
        # attractor that can pull the articular consensus off the head.
        gth_pre = np.deg2rad(groove_theta_deg) * sign
        def _bump(center, width_deg):
            d = np.arctan2(np.sin(tt - center), np.cos(tt - center))
            return np.exp(-0.5 * (d / np.deg2rad(width_deg)) ** 2)

        # both tuberosities flank the groove, which sits ~140 deg from the
        # head azimuth (see groove default above): a lobe near the head
        # azimuth would bulge under the medial anatomic-neck rim and bury
        # the rim crease under the calcar.
        bump_gt = _bump(gth_pre + sign * np.deg2rad(32.0), 38.0)  # greater
        bump_lt = _bump(gth_pre - sign * np.deg2rad(14.0), 18.0)  # lesser
        tub_shape = 0.62 + 0.38 * np.maximum(bump_gt, 0.65 * bump_lt)
        r_meta = shaft_radius + (
            metaphysis_scale * head_radius - shaft_radius
        ) * meta_frac * tub_shape
        r = np.maximum(r, r_meta)

    # proximal head: per (z, theta) ray from the canal axis, the surface of a
    # sphere |p - head_c| = head_radius seen from the axis point (0,0,z)
    dz = zz - head_c[2]
    under = head_radius**2 - dz**2
    ux, uy = np.cos(tt), np.sin(tt)
    b = ux * head_c[0] + uy * head_c[1]  # projection of center on ray
    c = head_c[0] ** 2 + head_c[1] ** 2 - under
    disc = b**2 - c
    hit = disc > 0
    r_head = np.where(hit, b + np.sqrt(np.maximum(disc, 0.0)), 0.0)

    # articular cap: sphere points above the true anatomic-neck plane
    # (p - head_c) . n_true >= cap_h.  Outside the cap the surface drops
    # off the sphere at 1.5 mm/mm into an anatomic-neck recess, so the
    # cap rim is a real geometric crease exactly on the truth plane.
    cap_h = 0.10 * head_radius
    px, py = r_head * ux, r_head * uy
    g = (
        (px - head_c[0]) * n_true[0]
        + (py - head_c[1]) * n_true[1]
        + (zz - head_c[2]) * n_true[2]
        - cap_h
    )
    on_cap = hit & (g >= 0.0)
    r_neckfall = r_head - np.clip(1.1 * (-g), 0.0, 6.0)
    r_art = np.where(on_cap, r_head, r_neckfall)
    head_wins = hit & (r_art > r)
    r = np.where(head_wins, r_art, r)
    label_cap = on_cap & head_wins

    # arthritic deformations
    if head_flattening > 0:
        # flatten one flank of the articular dome (cap-coordinate zone, so
        # the deformation tracks the head axis whatever NS/retro are)
        dome = _smoothstep(g, 0.1 * head_radius, 0.55 * head_radius)
        flat_dir = np.cos(tt - phi_h + sign * np.deg2rad(40.0))
        r = r - head_flattening * r * dome * np.clip(flat_dir, 0, 1) ** 2
    if osteophyte_amp > 0:
        # marginal osteophyte ridge hugging the anatomic-neck rim
        ridge = np.exp(-0.5 * (g / 2.0) ** 2) * hit
        r = r + osteophyte_amp * ridge * (0.6 + 0.4 * np.cos(3 * tt))
    if surface_noise > 0:
        rng_n = np.random.default_rng(12345)
        bumps = rng_n.normal(0, surface_noise, tt.shape)
        # keep it smooth-ish: average neighbors along theta
        bumps = (bumps + np.roll(bumps, 1, 1) + np.roll(bumps, -1, 1)) / 3.0
        zone = np.maximum(
            _smoothstep(zz, 0.7 * length, 0.8 * length) * (~on_cap),
            _smoothstep(g, -0.2 * head_radius, 0.2 * head_radius),
        )
        r = r + bumps * zone

    # bicipital groove: radial notch on the proximal third, sparing the
    # articular cap (the groove separates the tuberosities; it never cuts
    # articular cartilage)
    gth = np.deg2rad(groove_theta_deg) * sign
    dth = np.arctan2(np.sin(tt - gth), np.cos(tt - gth))
    gw = np.deg2rad(groove_width_deg)
    gmask = _smoothstep(zz, 0.68 * length, 0.74 * length) * (
        1.0 - _smoothstep(zz, 0.93 * length, 0.97 * length)
    )
    # sulcus with raised lips: real intertubercular grooves are flanked by
    # bony ridges, and the groove RF classifier (trained on real bones)
    # keys on exactly that notch-between-lips cross-section
    lips = 0.30 * groove_depth * (
        np.exp(-0.5 * ((dth - 1.6 * gw) / (gw / 2.0)) ** 2)
        + np.exp(-0.5 * ((dth + 1.6 * gw) / (gw / 2.0)) ** 2)
    )
    notch = (
        groove_depth * np.exp(-0.5 * (dth / (gw / 2.35)) ** 2) - lips
    ) * gmask
    r = r - notch * (~on_cap)

    # ring vertices (tiny positive floor keeps degenerate rays meshable)
    r = np.maximum(r, 0.8)
    vx = r * np.cos(tt)
    vy = r * np.sin(tt)
    verts = np.stack([vx, vy, zz], axis=-1).reshape(-1, 3)

    # caps: bottom apex on the axis; top apex at the head sphere's topmost
    # point, so the dome closure stays on the articular sphere
    bot_c = len(verts)
    top_c = len(verts) + 1
    top_apex = head_c + np.array([0.0, 0.0, head_radius])
    verts = np.vstack([verts, [[0.0, 0.0, z0 - 2.0]], [top_apex]])

    faces = []
    for i in range(n_rings - 1):
        for j in range(n_theta):
            a = i * n_theta + j
            b_ = i * n_theta + (j + 1) % n_theta
            c_ = (i + 1) * n_theta + j
            d = (i + 1) * n_theta + (j + 1) % n_theta
            faces.append([a, b_, c_])
            faces.append([b_, d, c_])
    for j in range(n_theta):
        faces.append([bot_c, (j + 1) % n_theta, j])
        base = (n_rings - 1) * n_theta
        faces.append([top_c, base + j, base + (j + 1) % n_theta])
    faces = np.asarray(faces, dtype=np.int64)

    if rng_transform is not None:
        q = rng_transform.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        t = rng_transform.uniform(-100, 100, size=3)
        verts = verts @ rot.T + t

    if return_head_label:
        # bottom apex is shaft; top apex sits on the articular sphere
        label = np.concatenate([label_cap.reshape(-1), [False, True]])
        return verts, faces, label
    return verts, faces
