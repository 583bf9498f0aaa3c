"""A/B the chain descriptor-build batch size (config.ContourDBConfig.
desc_batch) on the REAL headline chain.

Vmapped descriptor builds win when the CC stage is op-count-bound
(serialized small kernels) and lose when the single-scan build fuses into
the step; which holds depends on the descriptor lowering and the device.
This script settles the production knob by timing the FULL dyn chain (the
executable bench.py's headline times and step_chain_async runs) at
desc_batch in {16, 8, 4, 1} over identical scans/seeds.

Chain lengths 20/132 are residue-matched for every power-of-two batch
<= 16 (20 = 132 = 4 mod 16, = 4 mod 8, = 0 mod 4, = 0 mod 1), so the
differencing stays fair at each setting.

Run on the GPU:
    timeout 4200 python scripts/desc_batch_ab.py > descab.json \
        2>descab.log
CPU smoke: JAX_PLATFORMS=cpu CONT2_DESCAB_SMOKE=1.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(f"[descab +{time.perf_counter() - T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


def main():
    sys.path.insert(0, "tests")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from synth import make_world, render_scan

    import jax
    import jax.numpy as jnp

    smoke = os.environ.get("CONT2_DESCAB_SMOKE", "0") == "1"
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from contour_context_tpu.config import (ContourDBConfig,
                                            ContourManagerConfig,
                                            PipelineConfig)
    from contour_context_tpu.db import ContourDB
    from contour_context_tpu.utils.io import pad_points

    batches = [int(b) for b in os.environ.get(
        "CONT2_DESCAB", "16,8,4,1").split(",") if b.strip()]
    if smoke:
        batches = [4, 1]

    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)
    K_FILL = 36 if smoke else 132
    K_SMALL = 4 if smoke else 20
    REPS = 1 if smoke else 3
    N_LANES = 2
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
    log("rendering lanes (shared across batch settings)")
    clouds_fill = [render_lane(s) for s in range(N_LANES)]
    clouds_epoch = [render_lane(s % N_LANES, dy=1.5) for s in range(2)]
    sw_th.join()
    log(f"mode switch paid ({switch_info.get('s', 0):.1f}s, overlapped)")

    results = {}
    for bsz in batches:
        log(f"=== desc_batch {bsz} ===")
        cfg = PipelineConfig(
            cm=ContourManagerConfig(max_points=max_points),
            db=dataclasses.replace(ContourDBConfig(), desc_batch=bsz))

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
        for _ in range(REPS):
            for j, k in enumerate((K_SMALL, K_FILL)):
                base = take(k)
                plan.append((k, j, base, jax.device_put(
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
            log(f"B={bsz} chain({k}): {dt * 1e3:.1f} ms")
        dt_ms = (best[K_FILL] - best[K_SMALL]) / (K_FILL - K_SMALL) * 1e3
        recs = np.asarray(jax.device_get(db.recs_store[:db.n]))
        timed = recs[n_start:db.n]
        found = int(np.sum(timed[:, 0] > 0.5))
        results[str(bsz)] = {
            "ms": round(dt_ms, 3),
            "found": found,
            "timed_scans": int(timed.shape[0]),
            "chain_ms": {f"t{K_SMALL}": round(best[K_SMALL] * 1e3, 1),
                         f"t{K_FILL}": round(best[K_FILL] * 1e3, 1)},
        }
        log(f"desc_batch {bsz}: {dt_ms:.3f} ms/scan "
            f"(found {found}/{timed.shape[0]})")
        del db, pts_epoch
        import gc
        gc.collect()

    print(json.dumps({
        "metric": "headline dyn chain per-scan device time vs desc_batch "
                  "(identical scans/seeds; 2-lane fill)",
        "batches": results,
        "elapsed_s": round(time.perf_counter() - T0, 1),
    }), flush=True)
    log("done")


if __name__ == "__main__":
    main()
