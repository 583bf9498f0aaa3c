"""Zero-hint query cost across store sizes, stage by stage.

Sweeps store sizes with the production depth gates
(`db._query_step_impl(depth=...)`) to find (a) whether the zero-hint query
cost is monotone in the store size and (b) WHICH stage carries any
non-monotonicity (search = the cover2 top-k vs the rest of the fused
graph). The cover2 search's tile shapes change with the store size, so a
compiler's lowering can make one size slower than a larger one.

Measurement-only: no shipping code is touched. Store content is 16 real
descriptors tiled (ScanDesc is fixed-shape, so the query graph is identical
to the bench's at every max_points; the far probe is zero-hint either way —
hint counts are fetched and printed as proof).

Methodology: chained-dispatch differencing over a true device fetch; the
chain is a traced-bound fori_loop (one executable per (size, depth) —
n_iter rides as a runtime arg), query perturbed by an exact-1.0
data-dependent factor so XLA cannot hoist iterations. Run on the GPU:

    timeout 3000 python scripts/query_inversion_probe.py \
        > inv.json 2>inv.log
CPU smoke: JAX_PLATFORMS=cpu CONT2_INV_SMOKE=1.

Env: CONT2_INV_SIZES (default "16384,32768,65536,131072"),
     CONT2_INV_DEPTHS (default "search,full").
"""

import functools
import gc
import json
import os
import sys
import threading
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np

T0 = time.perf_counter()


def log(msg):
    print(f"[inv +{time.perf_counter() - T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from synth import make_world, render_scan

    from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
    from contour_context_tpu.db import (
        _keys_to_q_layout, _kq_dtype, _query_step_impl)
    from contour_context_tpu.ops.descriptor import build_descriptor
    from contour_context_tpu.utils.io import pad_points

    sizes = [int(x) for x in os.environ.get(
        "CONT2_INV_SIZES", "16384,32768,65536,131072").split(",") if x.strip()]
    depths = [d for d in os.environ.get(
        "CONT2_INV_DEPTHS", "search,full").split(",") if d.strip()]

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)

    # pay the first-fetch mode switch early, overlapped with rendering
    sw = {}

    def _pay():
        t0 = time.perf_counter()
        jax.device_get(jnp.zeros(4) + 2.0)
        sw["s"] = time.perf_counter() - t0

    th = threading.Thread(target=_pay, daemon=True)
    th.start()

    lane = [(-264.0 + 4.0 * i, -180.0 + 0.5 * (i % 7), 0.05 * (i % 11))
            for i in range(16)]
    clouds = [pad_points(render_scan(world, p, seed=int(rng.integers(1 << 30))),
                         cfg.cm.max_points) for p in lane]
    far_cloud = pad_points(render_scan(world, (-264.0, 780.0, 0.0), seed=77),
                           cfg.cm.max_points)
    th.join()
    log(f"mode switch paid ({sw['s']:.1f}s, overlapped); building 17 descs")

    build = jax.jit(lambda p: build_descriptor(p, cfg.cm, cfg.gmm))
    descs = [build(jnp.asarray(c)) for c in clouds]
    descs16 = jax.tree.map(lambda *xs: jnp.stack(xs), *descs)
    q_far = build(jnp.asarray(far_cloud))
    jax.block_until_ready(q_far)
    log("descs built")

    kq_jit = jax.jit(functools.partial(_keys_to_q_layout,
                                       dtype=_kq_dtype(cfg)))

    @functools.partial(jax.jit, static_argnames=("depth",))
    def chained(store, kq, q, searchable, n_iter, depth):
        def body(i, acc):
            one = 1.0 + 1e-30 * acc
            qq = jax.tree.map(
                lambda a: a * one.astype(a.dtype)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, q)
            d = None if depth == "full" else depth
            r = _query_step_impl(store, qq, searchable, cfg, kq, depth=d)
            return r.sum().astype(jnp.float32)
        return jax.lax.fori_loop(0, n_iter, body, jnp.float32(0.0))

    def timed(fn, *args):
        r = fn(*args)
        jax.device_get(r)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.device_get(fn(*args))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    K_SMALL, K_BIG = 4, 40
    out = {"sizes": sizes, "depths": depths, "hints": {}, "ms": {}}
    for n_db in sizes:
        log(f"--- store {n_db}")
        reps = -(-n_db // 16)
        store_b = jax.tree.map(
            lambda a: jnp.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n_db],
            descs16)
        kq = kq_jit(store_b.keys)
        searchable = jnp.int32(n_db - 32)
        jax.block_until_ready(kq)

        rec = np.asarray(jax.device_get(jax.jit(
            lambda s, k, q: _query_step_impl(s, q, searchable, cfg, k))(
                store_b, kq, q_far)))
        out["hints"][str(n_db)] = int(rec[6])
        log(f"far-probe hints={int(rec[6])} aft1={int(rec[7])}")

        for depth in depths:
            t1 = timed(chained, store_b, kq, q_far, searchable,
                       jnp.int32(K_SMALL), depth)
            tK = timed(chained, store_b, kq, q_far, searchable,
                       jnp.int32(K_BIG), depth)
            ms = (tK - t1) / (K_BIG - K_SMALL) * 1e3
            out["ms"][f"{n_db}_{depth}"] = round(ms, 3)
            log(f"{n_db} {depth}: {ms:.3f} ms/query "
                f"(t{K_SMALL}={t1 * 1e3:.0f}ms t{K_BIG}={tK * 1e3:.0f}ms)")
        store_b = kq = None
        gc.collect()

    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
