"""Synthetic LiDAR-like scene generator for tests.

Builds point clouds with pillar/wall structures of varying heights so the
multi-level contour extraction has nontrivial work, plus a pose-transformable
"world" so loop-closure tests can revisit places.
"""

from __future__ import annotations

import numpy as np


def make_world(seed: int, n_structs: int = 40, extent: float = 120.0):
    """A set of box structures: (cx, cy, sx, sy, height)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-extent, extent, n_structs)
    cy = rng.uniform(-extent, extent, n_structs)
    sx = rng.uniform(1.0, 8.0, n_structs)
    sy = rng.uniform(1.0, 8.0, n_structs)
    h = rng.uniform(0.5, 8.0, n_structs)
    return np.stack([cx, cy, sx, sy, h], axis=1)


def render_scan(world: np.ndarray, pose_xyt, seed: int = 0,
                pts_per_struct: int = 400, max_range: float = 70.0,
                noise: float = 0.03) -> np.ndarray:
    """Sample points from structures visible from pose (x, y, theta).

    Returns (N, 3) float32 points in the sensor frame (z: ground at -2.0,
    matching the KITTI lidar_height=2.0 convention).
    """
    px, py, pth = pose_xyt
    rng = np.random.default_rng(seed)
    pts = []
    for cx, cy, sx, sy, h in world:
        if np.hypot(cx - px, cy - py) > max_range:
            continue
        n = pts_per_struct
        xs = rng.uniform(cx - sx / 2, cx + sx / 2, n)
        ys = rng.uniform(cy - sy / 2, cy + sy / 2, n)
        zs = rng.uniform(0.0, h, n)
        pts.append(np.stack([xs, ys, zs], axis=1))
    # ground points
    ang = rng.uniform(0, 2 * np.pi, 4000)
    rad = rng.uniform(2.0, max_range, 4000)
    pts.append(np.stack([px + rad * np.cos(ang), py + rad * np.sin(ang),
                         np.zeros(4000)], axis=1))
    allp = np.concatenate(pts, axis=0)
    # world -> sensor frame
    c, s = np.cos(-pth), np.sin(-pth)
    dx, dy = allp[:, 0] - px, allp[:, 1] - py
    out = np.stack([c * dx - s * dy, s * dx + c * dy, allp[:, 2] - 2.0], axis=1)
    out += rng.normal(0, noise, out.shape)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# hardened renderer: occlusion + range-dependent density + dynamic clutter
# ---------------------------------------------------------------------------

def _ray_aabb_2d(px: float, py: float, dirs: np.ndarray,
                 boxes: np.ndarray) -> np.ndarray:
    """2-D slab intersection: entry distance (B, K) of each beam into each
    axis-aligned box footprint; +inf where the beam misses."""
    xmin = boxes[:, 0] - boxes[:, 2] / 2
    xmax = boxes[:, 0] + boxes[:, 2] / 2
    ymin = boxes[:, 1] - boxes[:, 3] / 2
    ymax = boxes[:, 1] + boxes[:, 3] / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        tx1 = (xmin[None] - px) / dirs[:, 0:1]
        tx2 = (xmax[None] - px) / dirs[:, 0:1]
        ty1 = (ymin[None] - py) / dirs[:, 1:2]
        ty2 = (ymax[None] - py) / dirs[:, 1:2]
    t_in = np.maximum(np.fmin(tx1, tx2), np.fmin(ty1, ty2))
    t_out = np.minimum(np.fmax(tx1, tx2), np.fmax(ty1, ty2))
    hit = (t_in <= t_out) & (t_out > 0)
    return np.where(hit, np.maximum(t_in, 1e-6), np.inf)


def sample_dynamic_objects(rng, pose_xyt, n: int,
                           r_range=(6.0, 40.0)) -> np.ndarray:
    """Car/pedestrian-sized transient boxes scattered around the sensor —
    re-sampled per scan, so revisits see DIFFERENT clutter."""
    px, py, _ = pose_xyt
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(*r_range, n)
    cx = px + rad * np.cos(ang)
    cy = py + rad * np.sin(ang)
    sx = rng.uniform(1.5, 4.5, n)
    sy = rng.uniform(1.5, 2.2, n)
    h = rng.uniform(1.2, 2.2, n)
    return np.stack([cx, cy, sx, sy, h], axis=1)


def render_scan_lidar(world: np.ndarray, pose_xyt, seed: int = 0,
                      n_azim: int = 900, max_range: float = 70.0,
                      noise: float = 0.03, lidar_height: float = 2.0,
                      vres_deg: float = 0.45, elev_lo_deg: float = -24.8,
                      elev_hi_deg: float = 8.0, n_dynamic: int = 0,
                      dropout: float = 0.0) -> np.ndarray:
    """Occlusion-aware spinning-LiDAR renderer (the hard-mode twin of
    render_scan).

    Per azimuth beam, the NEAREST structure footprint blocks everything
    behind it (2-D raycast), and the vertical ring fan (HDL-64-like: fixed
    elevation angles every `vres_deg`) decides how many points land on that
    structure's wall — so nearby walls are dense, distant walls sparse, and
    ground return density falls off with range exactly as ring geometry
    dictates. `n_dynamic` > 0 adds per-scan transient clutter boxes (parked/
    moving cars) that occlude and get scanned like static structure but
    differ between visits. `dropout` drops that fraction of returns
    (reflectivity/rain). Returns (N, 3) float32 sensor-frame points
    (z: ground at -lidar_height)."""
    px, py, pth = pose_xyt
    rng = np.random.default_rng(seed)
    boxes = world
    if n_dynamic:
        boxes = np.concatenate(
            [world, sample_dynamic_objects(rng, pose_xyt, n_dynamic)], axis=0)

    azim = rng.uniform(0, 2 * np.pi / n_azim) + \
        np.arange(n_azim) * (2 * np.pi / n_azim)
    dirs = np.stack([np.cos(azim), np.sin(azim)], axis=1)
    t_all = _ray_aabb_2d(px, py, dirs, boxes)        # (B, K)
    near_k = np.argmin(t_all, axis=1)
    t_near = t_all[np.arange(n_azim), near_k]        # (B,)
    h_near = boxes[near_k, 4]

    tan_e = np.tan(np.deg2rad(
        np.arange(elev_lo_deg, elev_hi_deg, vres_deg)))   # (R,)

    # wall returns: ring hits the blocking wall at height z in [0, h]
    z_wall = lidar_height + t_near[:, None] * tan_e[None, :]
    wall_ok = (np.isfinite(t_near)[:, None] & (t_near[:, None] < max_range)
               & (z_wall >= 0.0) & (z_wall <= h_near[:, None]))
    bi, ri = np.nonzero(wall_ok)
    wall_pts = np.stack([px + t_near[bi] * dirs[bi, 0],
                         py + t_near[bi] * dirs[bi, 1],
                         z_wall[bi, ri]], axis=1)

    # ground returns: downward rings that reach the ground before any wall
    with np.errstate(divide="ignore"):
        r_gnd = np.where(tan_e < 0, -lidar_height / tan_e, np.inf)  # (R,)
    gnd_ok = (r_gnd[None, :] < np.minimum(t_near, max_range)[:, None])
    bi, ri = np.nonzero(gnd_ok)
    gnd_pts = np.stack([px + r_gnd[ri] * dirs[bi, 0],
                        py + r_gnd[ri] * dirs[bi, 1],
                        np.zeros(len(bi))], axis=1)

    allp = np.concatenate([wall_pts, gnd_pts], axis=0)
    if dropout > 0.0:
        allp = allp[rng.random(len(allp)) >= dropout]
    # world -> sensor frame
    c, s = np.cos(-pth), np.sin(-pth)
    dx, dy = allp[:, 0] - px, allp[:, 1] - py
    out = np.stack([c * dx - s * dy, s * dx + c * dy,
                    allp[:, 2] - lidar_height], axis=1)
    out += rng.normal(0, noise, out.shape)
    return out.astype(np.float32)


def make_aliasing_world(seed: int, n_cell: int = 3, spacing: float = 100.0,
                        n_unique: int = 8):
    """Distractor world: an n_cell x n_cell grid of IDENTICAL structure motifs
    plus a few cell-specific boxes.

    Every cell shares the same 8-box motif layout, so anchor retrieval keys
    (ellipse stats + 10 m ring histogram) are near-identical across cells —
    a key-only matcher confuses cells freely. The unique boxes (comparable
    total area, different layout per cell) only show up in the WIDE-radius
    evidence: BCI constellations and the GMM L2 correlation. Discriminating
    the true revisit from an aliased cell therefore requires exactly the
    cascade stages the reference was built around (contour_db.h:374-488).

    Returns (world, cell_centers)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, 8)
    rad = rng.uniform(8.0, 24.0, 8)
    motif = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                      rng.uniform(4.0, 9.0, 8), rng.uniform(4.0, 9.0, 8),
                      rng.uniform(3.0, 8.0, 8)], axis=1)
    cells = []
    boxes = []
    for i in range(n_cell):
        for j in range(n_cell):
            cx, cy = i * spacing, j * spacing
            cells.append((cx, cy))
            m = motif.copy()
            m[:, 0] += cx
            m[:, 1] += cy
            boxes.append(m)
            ua = rng.uniform(0, 2 * np.pi, n_unique)
            ur = rng.uniform(12.0, 30.0, n_unique)
            boxes.append(np.stack([
                cx + ur * np.cos(ua), cy + ur * np.sin(ua),
                rng.uniform(4.0, 8.0, n_unique),
                rng.uniform(4.0, 8.0, n_unique),
                rng.uniform(3.0, 8.0, n_unique)], axis=1))
    return np.concatenate(boxes, axis=0), cells


def se3_from_xyt(pose_xyt) -> np.ndarray:
    x, y, th = pose_xyt
    T = np.eye(4)
    c, s = np.cos(th), np.sin(th)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


def build_trajectory(n_scans: int, rng) -> list:
    """A loopy path: several out-and-back excursions over a street grid."""
    poses = []
    x = y = th = 0.0
    # waypoint circuit revisited on later laps with small lateral offsets;
    # lap length capped so the circuit stays inside the structured world
    # (8 m steps, world extent ~180 m -> side <= 8 * (72 // 4) = 144 m)
    lap_len = min(max(20, n_scans // 3), 72)
    for i in range(n_scans):
        lap = i // lap_len
        k = i % lap_len
        # square circuit, 8 m steps
        side = k * 4 // lap_len
        step = 8.0
        if side == 0:
            x, y, th = step * (k % (lap_len // 4)) * 1.0, 0.0, 0.0
        elif side == 1:
            x, y, th = step * (lap_len // 4), step * (k % (lap_len // 4)), 1.5708
        elif side == 2:
            x, y, th = step * (lap_len // 4) - step * (k % (lap_len // 4)), \
                step * (lap_len // 4), 3.1416
        else:
            x, y, th = 0.0, step * (lap_len // 4) - step * (k % (lap_len // 4)), \
                -1.5708
        jitter = 0.6 * lap
        poses.append((x + rng.uniform(-0.3, 0.3) + jitter,
                      y + rng.uniform(-0.3, 0.3),
                      th + rng.uniform(-0.05, 0.05)))
    return poses


def write_synth_dataset(out_dir: str, world: np.ndarray, poses, rng,
                        render=render_scan, ts_step: float = 1.0):
    """Render `poses` and write them as an on-disk dataset in the KITTI
    two-file format: per-scan float32 x4 `.bin` files under out_dir/bins, a
    13-column "ts pose(3x4)" file and a "ts seq path" scan list, with
    timestamps `ts_step` seconds apart. Scan i is rendered with seed
    rng.integers(1 << 30), drawn in scan order. Returns (f_pose, f_lid)."""
    import os

    bin_dir = os.path.join(out_dir, "bins")
    os.makedirs(bin_dir, exist_ok=True)
    pose_lines, lid_lines = [], []
    for i, p in enumerate(poses):
        pts = render(world, p, seed=int(rng.integers(1 << 30)))
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = os.path.join(bin_dir, "%06d.bin" % i)
        arr.tofile(bp)
        ts = ts_step * i
        T = se3_from_xyt(p)
        pose_lines.append("%.6f %s" % (ts, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
        lid_lines.append("%.6f %d %s" % (ts, i, bp))
    f_pose = os.path.join(out_dir, "ts-sens_pose-synth.txt")
    f_lid = os.path.join(out_dir, "ts-lidar_bins-synth.txt")
    with open(f_pose, "w") as f:
        f.write("\n".join(pose_lines))
    with open(f_lid, "w") as f:
        f.write("\n".join(lid_lines))
    return f_pose, f_lid
