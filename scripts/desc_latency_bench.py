"""Sub-stage device-time breakdown of the descriptor build.

Times PARTIAL DEPTHS of build_descriptor — raster -> masks+CC -> component
tables -> keys -> bcis+gmm (= full) — each as a chained single-dispatch
measurement (lax.scan of K data-dependent iterations differenced over a
device_get). Successive depth differences give per-stage cost. Also
isolates the raster's two scatters and the count-table scatter
individually.

Run on the GPU:
    timeout 900 python scripts/desc_latency_bench.py > desc.log 2>&1
"""

import argparse
import functools
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chain", type=int, default=21)
    ap.add_argument("--max-points", type=int, default=131072)
    ap.add_argument("--micro-only", action="store_true",
                    help="skip the cumulative depth series; run only the isolated micro-splits")
    ap.add_argument("--vmap", type=int, default=1,
                    help="batch the depth series over N vmapped scans (the "
                         "shipping chains build descriptors in vmapped "
                         "16-scan chunks); per-scan ms = slope / N")
    args = ap.parse_args()
    K = args.chain

    import jax
    import jax.numpy as jnp
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from synth import make_world, render_scan

    from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
    from contour_context_tpu.ops.descriptor import (cc_labels,
                                                    component_tables,
                                                    gmm_summary, make_bcis,
                                                    make_keys, rasterize_bev)
    from contour_context_tpu.utils.io import pad_points

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=args.max_points))
    cm = cfg.cm
    world = make_world(1, n_structs=300, extent=400.0)
    pts_np = pad_points(render_scan(world, (40.0, 2.0, 0.3), seed=7),
                        cm.max_points)
    pts0 = jax.device_put(jnp.asarray(pts_np))
    V = max(1, args.vmap)
    if V > 1:
        pts_v = np.stack([
            pad_points(render_scan(world, (40.0 + 4.0 * i, 2.0, 0.3),
                                   seed=7 + i), cm.max_points)
            for i in range(V)])
        pts0_v = jax.device_put(jnp.asarray(pts_v))

    t0 = time.time()
    _ = jax.device_get(jnp.zeros(4) + 1)
    print(f"mode switch paid ({time.time() - t0:.0f} s)", flush=True)

    def timed(fn, *fn_args):
        r = fn(*fn_args)
        jax.device_get(r)
        ts_ = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = fn(*fn_args)
            jax.device_get(r)
            ts_.append(time.perf_counter() - t0)
        return min(ts_)

    def per_op(name, chained, *extra):
        t1 = timed(chained, *extra, 1)
        tK = timed(chained, *extra, K)
        ms = (tK - t1) / (K - 1) * 1e3
        print(f"{name}: {ms:.3f} ms  (t1={t1 * 1e3:.1f}, tK={tK * 1e3:.1f})",
              flush=True)
        return ms

    nr, nc = cm.n_row, cm.n_col

    def desc_depth(points, depth: str):
        bev, rowf, colf = rasterize_bev(points, cm)
        if depth == "raster":
            return bev.sum() + rowf.sum() + colf.sum()
        grads = jnp.array(cm.lv_grads, jnp.float32)
        masks = (bev.reshape(nr, nc)[None] > grads[:, None, None])
        if depth == "masks":
            return bev.sum() + masks.sum().astype(jnp.float32)
        labels = cc_labels(masks)
        if depth == "cc":
            return bev.sum() + labels.sum().astype(jnp.float32)
        tab = component_tables(labels, masks.reshape(cm.n_levels, -1),
                               bev, rowf, colf, cm)
        if depth == "tables":
            return (tab["mean"].sum() + tab["eig_vals"].sum()
                    + tab["cnt"].sum().astype(jnp.float32))
        keys, anch_valid, pix_overflow = make_keys(tab, bev, rowf, colf, cm)
        if depth == "keys":
            return keys.sum() + tab["mean"].sum()
        bci = make_bcis(tab, anch_valid, cm)
        gmm_mask, auto_corr, gmm_overflow = gmm_summary(tab, cfg.gmm)
        return (keys.sum() + bci["nei_theta"].sum() + auto_corr
                + gmm_mask.sum().astype(jnp.float32))

    @functools.partial(jax.jit, static_argnames=("depth", "n_iter"))
    def chained_depth(points, n_iter, depth):
        def body(p, _):
            if V > 1:
                s = jax.vmap(lambda q: desc_depth(q, depth))(p).sum()
            else:
                s = desc_depth(p, depth)
            return p * (1.0 + 1e-30 * s).astype(p.dtype), s
        p, ss = jax.lax.scan(body, points, None, length=n_iter)
        return ss[-1]

    prev = 0.0
    for depth in (() if args.micro_only else
                  ("raster", "masks", "cc", "tables", "keys", "full")):
        def f(points, n_iter, d=depth):
            return chained_depth(points, n_iter, d)
        ms = per_op(f"desc depth={depth}" + (f" (vmap {V} total)"
                                             if V > 1 else ""), f,
                    pts0_v if V > 1 else pts0) / V
        print(f"   stage delta [{depth}]: {ms - prev:+.3f} ms/scan",
              flush=True)
        prev = ms

    # ---- raster micro-splits -------------------------------------------------
    S = nr * nc
    x, y, z, flag = (pts0[:, 0], pts0[:, 1], pts0[:, 2], pts0[:, 3])
    pad = 1e-2
    x_min, x_max = -(nr // 2) * cm.reso_row, (nr // 2) * cm.reso_row
    y_min, y_max = -(nc // 2) * cm.reso_col, (nc // 2) * cm.reso_col
    ok = ((flag > 0) & (x >= x_min + pad) & (x <= x_max - pad)
          & (y >= y_min + pad) & (y <= y_max - pad)
          & (x * x + y * y >= cm.blind_sq))
    row = jnp.floor(x / cm.reso_row).astype(jnp.int32) + nr // 2
    col = jnp.floor(y / cm.reso_col).astype(jnp.int32) + nc // 2
    ok &= row > 0
    pid = jnp.where(ok, row * nc + col, S).astype(jnp.int32)
    h = jnp.where(ok, z + cm.lidar_height, -1e9)
    pid = jax.device_put(pid)
    h = jax.device_put(h)

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_scatter_max(pidv, hv, n_iter):
        def body(c, _):
            bev = jnp.full(S + 1, -1e9, jnp.float32).at[pidv].max(hv + c)
            return c + 1e-30 * bev.sum(), None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n_iter)
        return c

    per_op("raster/scatter-max only", chained_scatter_max, pid, h)

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_gather(pidv, hv, n_iter):
        bev0 = jnp.full(S + 1, -1e9, jnp.float32).at[pidv].max(hv)

        def body(c, _):
            g = (bev0 + c)[pidv]
            return c + 1e-30 * g.sum(), None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n_iter)
        return c

    per_op("raster/bev[pid] gather only", chained_gather, pid, h)

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_sort(pidv, hv, n_iter):
        P = pidv.shape[0]
        idx = jnp.arange(P, dtype=jnp.int32)

        def body(c, _):
            sp, sh, si = jax.lax.sort((pidv, -(hv + c), idx), num_keys=3)
            return c + 1e-30 * (sh[0] + si[0].astype(jnp.float32)), None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n_iter)
        return c

    per_op("raster/3-key sort of P points", chained_sort, pid, h)

    # count-table scatter (component_tables' remaining full-width scatter)
    bev, rowf, colf = jax.jit(
        lambda p: rasterize_bev(p, cm))(pts0)
    grads = jnp.array(cm.lv_grads, jnp.float32)
    masks = jax.device_put(bev.reshape(nr, nc)[None] > grads[:, None, None])
    labels = jax.device_put(jax.jit(cc_labels)(masks))
    masks_flat = masks.reshape(cm.n_levels, -1)

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_cnt_scatter(lab, mf, n_iter):
        def body(c, _):
            cnt = jax.vmap(lambda lb, m: jnp.zeros(S + 1, jnp.float32)
                           .at[lb].add(m.astype(jnp.float32) + c))(lab, mf)
            return c + 1e-30 * cnt.sum(), None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n_iter)
        return c

    per_op("tables/count seg-sum scatter only", chained_cnt_scatter,
           labels, masks_flat)

    # ---- component_tables micro-splits (isolated pieces, not cumulative:
    # each times ONE internal block of descriptor.component_tables on
    # pre-staged inputs, so the splits attribute its stage delta) ----------
    L = cm.n_levels
    K_top = cm.max_contours
    iota_s = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (L, S))

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_sort_runlen(lab, mf, n_iter):
        def body(c, _):
            sl, pos = jax.lax.sort((lab + c, iota_s), dimension=1, num_keys=1)
            rs = jnp.concatenate(
                [jnp.ones((L, 1), bool), sl[:, 1:] != sl[:, :-1]], axis=1)
            spos = jax.lax.associative_scan(
                jnp.maximum, jnp.where(rs, iota_s, -1), axis=1)
            ns = jax.lax.associative_scan(
                jnp.minimum, jnp.where(rs, iota_s, S), axis=1, reverse=True)
            nxt = jnp.concatenate([ns[:, 1:], jnp.full((L, 1), S, jnp.int32)],
                                  axis=1)
            cnt_sorted = nxt - spos
            _, cnt_pix = jax.lax.sort((pos, cnt_sorted), dimension=1,
                                      num_keys=1)
            return c + (cnt_pix.sum() % 2).astype(jnp.int32), None
        c, _ = jax.lax.scan(body, jnp.int32(0), None, length=n_iter)
        return c

    per_op("tables/sort+runlen (2 sorts + 2 scans)", chained_sort_runlen,
           labels, masks_flat)

    # stage rep/sel inputs once (host-free: jitted producers)
    tab = jax.jit(lambda lb, mf: component_tables(lb, mf, bev, rowf, colf,
                                                  cm))(labels, masks_flat)
    rep_idx = jnp.argsort(jnp.where(tab["valid"], 0, 1), axis=1)[:, :K_top]

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_topk_argsort(lab, n_iter):
        def body(c, _):
            key = jnp.where(lab == iota_s, -(lab + c), 1)
            order_k = jnp.argsort(key, axis=1, stable=True)[:, :K_top]
            return c + (order_k.sum() % 2), None
        c, _ = jax.lax.scan(body, jnp.int32(0), None, length=n_iter)
        return c

    per_op("tables/top-K stable argsort", chained_topk_argsort, labels)

    rep = jax.device_put(jnp.where(
        jnp.arange(K_top)[None] < 5, iota_s[:, :K_top], S))

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_sel_einsum(lab, rp, n_iter):
        ch1 = jnp.stack([rowf, colf, bev, bev * rowf, bev * colf])

        def body(c, _):
            sel = (lab[:, None, :] == jnp.minimum(rp + c, S - 1)[:, :, None]) \
                & (rp[:, :, None] < S)
            sums = jnp.einsum("lks,cs->lkc", sel.astype(jnp.float32), ch1,
                              precision=jax.lax.Precision.HIGHEST)
            return c + (sums[..., 0].sum().astype(jnp.int32) % 2), None
        c, _ = jax.lax.scan(body, jnp.int32(0), None, length=n_iter)
        return c

    per_op("tables/sel+einsum (first moments)", chained_sel_einsum,
           labels, rep)

    mean_r = jax.device_put(tab["mean"][..., 0])
    mean_c = jax.device_put(tab["mean"][..., 1])

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_second_pass(lab, rp, mr, mc, n_iter):
        def body(c, _):
            sel = (lab[:, None, :] == jnp.minimum(rp, S - 1)[:, :, None]) \
                & (rp[:, :, None] < S)
            dr = jnp.where(sel, rowf[None, None, :] - (mr + c)[:, :, None],
                           0.0)
            dc = jnp.where(sel, colf[None, None, :] - mc[:, :, None], 0.0)
            a = jnp.sum(dr * dr, axis=-1)
            b = jnp.sum(dr * dc, axis=-1)
            cc = jnp.sum(dc * dc, axis=-1)
            return c + 1e-30 * (a.sum() + b.sum() + cc.sum()), None
        c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n_iter)
        return c

    per_op("tables/second pass (dr/dc reductions)", chained_second_pass,
           labels, rep, mean_r, mean_c)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
