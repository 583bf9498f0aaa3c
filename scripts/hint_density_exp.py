"""Hint-density workload study: how close can a synthetic world get to the
reference's KITTI 08 retrieval load (~17.9 cascade candidates/scan,
`/root/reference/log/timing_cont2_paper.txt`) without losing its retrieval
recall (R=0.94 at max-F1)?

Replicates `db._search_impl`'s adaptive-ub hint criterion in numpy over
descriptors built on CPU, over several world designs, and tracks BOTH the
admitted-hint count and whether the true revisit scan is among the hints
(`revisit_hit`, the retrieval-recall proxy).

Results (3 fill lanes x 44 poses + 1 offset re-drive, 12 m spacing;
bench.py's world is `uniform`; hint counts are device-independent):

| world                         | hints mean (p50/p90) | revisit_hit |
|-------------------------------|----------------------|-------------|
| uniform (bench.py workload)   | 463 (448/681)        | 44/44       |
| districts cell=80 (< range)   | 691 — mixtures wash out | 44/44    |
| districts cell=250            | 384..47 by seed; p50 can hit 0 (empty scans) | degrades |
| graded cell=200 (unique size x height combos) | 89..265 | 41..44/44 |
| graded + within-cell ramps    | 61..209              | 36..43/44   |
| graded + per-cell count 6..45 | 164..302 (CLT: window statistics self-average) | 40..44/44 |
| uniform + occlusion renderer  | 56..111              | 26..34/44   |
| graded + occlusion renderer   | 14..62               | 22..29/44   |

Conclusion (recorded in PARITY.md round-3 section): box-world statistics
concentrate (CLT over ~7-30 structures in range), so without occlusion the
key gate (20-25% relative, `contour_db.h` search ratios) admits most of the
store; occlusion+viewpoint dependence reaches KITTI's density but collapses
retrieval recall far below KITTI's. No synthetic design reached BOTH, so
bench.py keeps the uniform world and reports hints_per_scan in its JSON —
the headline carries ~25x the reference's cascade candidate load.

Usage: python scripts/hint_density_exp.py [uniform|graded|lidar] [seeds...]
"""
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")
import numpy as np
import jax
import jax.numpy as jnp

from synth import make_world, render_scan, render_scan_lidar

from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu.ops.descriptor import build_descriptor
from contour_context_tpu.utils.io import pad_points

MAXP = 131072
cfg = PipelineConfig(cm=ContourManagerConfig(max_points=MAXP))
Q_LEVELS = (1, 2, 3)    # query levels, as db._search_impl


def make_graded_world(seed, extent=400.0, cell=200.0, density=300 / 800.0**2,
                      size_mults=(0.6, 0.9, 1.35, 2.0),
                      height_mults=(0.5, 0.8, 1.25, 2.0)):
    """Box world with a UNIQUE per-cell (size, height) multiplier combo on a
    grid coarser than the sensor range: cross-cell aliasing is designed out;
    what remains is within-cell aliasing (scans in the same cell share key
    statistics up to box-placement noise)."""
    rng = np.random.default_rng(seed)
    nx = int(np.ceil(2 * extent / cell))
    combos = [(s, h) for s in size_mults for h in height_mults]
    perm = rng.permutation(len(combos))
    boxes = []
    k = 0
    for ix in range(nx):
        for iy in range(nx):
            x0, y0 = -extent + ix * cell, -extent + iy * cell
            ms, mh = combos[perm[(ix * nx + iy) % len(combos)]]
            r = np.random.default_rng(seed * 1000003 + k)
            k += 1
            n = max(1, int(round(density * cell * cell)))
            cx = r.uniform(x0, x0 + cell, n)
            cy = r.uniform(y0, y0 + cell, n)
            sx = r.uniform(1.0, 8.0, n) * ms
            sy = r.uniform(1.0, 8.0, n) * ms
            h = r.uniform(0.5, 8.0, n) * mh
            boxes.append(np.stack([cx, cy, sx, sy, h], axis=1))
    return np.concatenate(boxes)


def lane_poses(lane, n, dy=0.0, spacing=12.0):
    y0 = -300.0 + 120.0 * lane + dy
    return [(-264.0 + spacing * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
            for i in range(n)]


def keys_for(world, poses, rng, render):
    build = jax.jit(lambda p: build_descriptor(p, cfg.cm, cfg.gmm).keys)
    out, maxn = [], 0
    for p in poses:
        pts = render(world, p, seed=int(rng.integers(1 << 30)))
        maxn = max(maxn, len(pts))
        out.append(np.asarray(build(jnp.asarray(pad_points(pts, MAXP)))))
    return np.stack(out), maxn          # (N, L, A, 10)


def hint_stats(keys, n_fill, lane_of, x_of, nnk=50):
    """Mirror of db._search_impl's admission: per (query level, anchor),
    candidates within the adaptive ub (search ratios 0.8 / 0.8*0.75 on key
    components 0-2, contour_db.h), capped at nnk each."""
    counts, revisit_ok = [], []
    for i in range(n_fill, keys.shape[0]):
        store = keys[:n_fill][:, Q_LEVELS, :, :]
        hit_rows = set()
        tot = 0
        for li, L in enumerate(Q_LEVELS):
            for a in range(keys.shape[2]):
                q = keys[i, L, a]
                if not q.any():
                    continue
                k0, k1, k2 = q[0], q[1], q[2]
                ub = (max((k0 - k0 * 0.8) ** 2, (k0 - k0 / 0.8) ** 2)
                      + max((k1 - k1 * 0.8) ** 2, (k1 - k1 / 0.8) ** 2)
                      + max((k2 - k2 * 0.8 * 0.75) ** 2,
                            (k2 - k2 / (0.8 * 0.75)) ** 2))
                cand = store[:, li].reshape(-1, 10)
                valid = cand.any(axis=1)
                d2 = ((cand - q) ** 2).sum(axis=1)
                adm = (d2 < ub) & valid
                tot += min(int(adm.sum()), nnk)
                rows = np.nonzero(adm.reshape(n_fill, -1).any(axis=1))[0]
                hit_rows.update(rows.tolist())
        counts.append(tot)
        tgt = [j for j in range(n_fill)
               if lane_of[j] == lane_of[i] and abs(x_of[j] - x_of[i]) < 6.0]
        revisit_ok.append(any(j in hit_rows for j in tgt))
    c = np.array(counts)
    return dict(mean=round(float(c.mean()), 1),
                p50=float(np.percentile(c, 50)),
                p90=round(float(np.percentile(c, 90)), 1), max=int(c.max()),
                revisit_hit=f"{sum(revisit_ok)}/{len(revisit_ok)}")


def run(name, world, render=render_scan):
    rng = np.random.default_rng(0)
    t0 = time.time()
    poses, lane_of, x_of = [], [], []
    n_per = 44
    for lane in range(3):
        ps = lane_poses(lane, n_per)
        poses += ps
        lane_of += [lane] * n_per
        x_of += [p[0] for p in ps]
    ps = lane_poses(0, n_per, dy=1.5)
    poses += ps
    lane_of += [0] * n_per
    x_of += [p[0] for p in ps]
    keys, maxn = keys_for(world, poses, rng, render)
    st = hint_stats(keys, 3 * n_per, lane_of, x_of)
    print(f"{name}: {st}  max_real_points={maxn}  ({time.time() - t0:.0f}s)",
          flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "uniform"
    seeds = [int(s) for s in sys.argv[2:]] or [1, 2, 3]
    for seed in seeds:
        if which == "uniform":
            run(f"uniform(seed={seed})",
                make_world(seed, n_structs=300, extent=400.0))
        elif which == "graded":
            run(f"graded(cell=200,seed={seed})", make_graded_world(seed))
        elif which == "lidar":
            run(f"uniform+lidar(seed={seed})",
                make_world(seed, n_structs=300, extent=400.0),
                render=render_scan_lidar)
        else:
            raise SystemExit(f"unknown world {which}")
