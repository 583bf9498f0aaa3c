"""Hint-cap vs recall vs latency sweep on the SAME epochs.

At ~35x-KITTI hint density the fixed hint cap (max_check_cands) drops part
of the hits each scan. This script measures the tradeoff ON THE SAME WORLD,
SCANS AND SEEDS for a ladder of `max_check_cands` caps, so a shipping point
can be chosen with both numbers on the table:

    cap in {128, 256, 512, 1024} (CONT2_CAP_SWEEP to override)
    -> per-scan device time (chained-dispatch differencing, bench.py
       methodology) x loops-found on the timed pure-revisit epochs
       x overflow counters.

Everything except `max_check_cands` stays at shipping defaults (chunked
cascade W=128, check-1 prefilter, p_pot=128, max_pass_hints=128), so the
sweep isolates the hint cap. Scans are rendered ONCE and identical for
every cap; `missed_rows` lets found-SETS be diffed across caps.

Run on the GPU:
    timeout 3600 python scripts/cap_recall_bench.py > capsweep.json \
        2>capsweep.log
CPU smoke: JAX_PLATFORMS=cpu CONT2_CAP_SMOKE=1.

Output: ONE JSON line {caps: {cap: {ms, found, ...}}, ...}.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

BASELINE_MS = 11.0


def log(msg):
    print(f"[capsweep +{time.perf_counter() - T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


def main():
    sys.path.insert(0, "tests")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from synth import make_world, render_scan

    import jax
    import jax.numpy as jnp

    smoke = os.environ.get("CONT2_CAP_SMOKE", "0") == "1"
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from contour_context_tpu.config import (ContourDBConfig,
                                            ContourManagerConfig,
                                            PipelineConfig)
    from contour_context_tpu.db import ContourDB
    from contour_context_tpu.utils.io import pad_points

    caps = [int(c) for c in os.environ.get(
        "CONT2_CAP_SWEEP", "128,256,512,1024").split(",") if c.strip()]
    if smoke:
        caps = [32, 64]

    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)
    K_FILL = 36 if smoke else 132
    K_SMALL = 4 if smoke else 20
    REPS = 1 if smoke else 2
    N_LANES = 2 if smoke else 4
    P_C = 12288
    max_points = 16384 if smoke else 131072

    def lane_poses(lane, dy=0.0):
        y0 = -300.0 + 120.0 * lane + dy
        return [(-264.0 + 4.0 * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
                for i in range(K_FILL)]

    def render_lane(lane, dy=0.0):
        rows = []
        for p in lane_poses(lane, dy):
            pts = render_scan(world, p, seed=int(rng.integers(1 << 30)))
            assert len(pts) <= P_C
            rows.append(pad_points(pts, P_C))
        return np.stack(rows)

    def fetch1(x):
        return jax.device_get(x.ravel()[:1])

    import threading
    switch_info = {}

    def _pay_switch():
        t0 = time.perf_counter()
        fetch1(jnp.zeros(4) + 2.0)
        switch_info["s"] = time.perf_counter() - t0

    sw_th = threading.Thread(target=_pay_switch, daemon=True)
    sw_th.start()
    log(f"rendering {N_LANES} fill lanes + epochs (shared across caps)")
    clouds_fill = [render_lane(s) for s in range(N_LANES)]
    clouds_epoch = [render_lane(s % N_LANES, dy=1.5)
                    for s in range(2 * REPS)]
    sw_th.join()
    log(f"mode switch paid ({switch_info.get('s', 0):.1f}s, overlapped)")

    results = {}
    for cap in caps:
        log(f"=== cap {cap} ===")
        cfg = PipelineConfig(
            cm=ContourManagerConfig(max_points=max_points),
            db=dataclasses.replace(ContourDBConfig(), max_check_cands=cap))

        @jax.jit
        def devpad(c):
            pad = jnp.zeros((c.shape[0], cfg.cm.max_points - P_C, 4),
                            c.dtype)
            pad = pad.at[:, :, 0].set(1e6)
            return jnp.concatenate([c, pad], axis=1)

        db = ContourDB(cfg, capacity=N_LANES * K_FILL
                       + REPS * (K_SMALL + K_FILL) + 8)
        nid = [0]

        def take(k):
            s = nid[0]
            nid[0] += k
            return s

        for s in range(N_LANES):
            base = take(K_FILL)
            ts_f = jax.device_put(
                np.arange(base, base + K_FILL, dtype=np.float32))
            h = db.step_chain_dyn_async(
                devpad(jax.device_put(clouds_fill[s])),
                list(range(base, base + K_FILL)), ts_f)
            jax.block_until_ready(h.recs)
        pts_epoch = [devpad(jax.device_put(c)) for c in clouds_epoch]
        staged_k = {k: db.stage_chain_k(k) for k in (K_SMALL, K_FILL)}
        plan = []
        for r in range(REPS):
            for j, k in enumerate((K_SMALL, K_FILL)):
                base = take(k)
                plan.append((k, 2 * r + j, base, jax.device_put(
                    np.arange(base, base + K_FILL, dtype=np.float32))))
        jax.block_until_ready([t for _, _, _, t in plan])

        n_start = db.n
        best = {K_SMALL: None, K_FILL: None}
        for k, lane, base, ts_k in plan:
            t0 = time.perf_counter()
            h = db.step_chain_dyn_async(pts_epoch[lane],
                                        list(range(base, base + k)), ts_k,
                                        k_dev=staged_k[k])
            fetch1(h.recs)
            dt = time.perf_counter() - t0
            best[k] = dt if best[k] is None else min(best[k], dt)
            log(f"cap {cap} chain({k}): {dt * 1e3:.1f} ms")
        dt_ms = (best[K_FILL] - best[K_SMALL]) / (K_FILL - K_SMALL) * 1e3

        recs = np.asarray(jax.device_get(db.recs_store[:db.n]))
        timed = recs[n_start:db.n]
        found = int(np.sum(timed[:, 0] > 0.5))
        results[str(cap)] = {
            "ms": round(dt_ms, 3),
            "vs_baseline": round(BASELINE_MS / dt_ms, 3),
            "found": found,
            "timed_scans": int(timed.shape[0]),
            "found_rate": round(found / max(1, timed.shape[0]), 4),
            "hints_precap_mean": round(float(timed[:, 6].mean()), 1),
            "overflow_hints": int(timed[:, 11].sum()),
            "overflow_pass": int(timed[:, 12].sum()),
            "missed_rows": [int(i) for i in
                            np.flatnonzero(timed[:, 0] <= 0.5)][:64],
        }
        log(f"cap {cap}: {dt_ms:.3f} ms/scan, found {found}/{timed.shape[0]}")
        del db, pts_epoch
        import gc
        gc.collect()

    out = {
        "metric": "hint-cap sweep: per-scan device time x recall on "
                  "identical pure-revisit epochs (bench.py world/geometry; "
                  "shipping defaults except max_check_cands)",
        "caps": results,
        "elapsed_s": round(time.perf_counter() - T0, 1),
    }
    print(json.dumps(out), flush=True)
    log("done")


if __name__ == "__main__":
    main()
