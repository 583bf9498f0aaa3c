"""Stage decomposition of the SHIPPING headline chain (bench.py).

Measures every stage IN THE SHIPPING CONFIGURATION, so the split can be
checked against the headline number itself:

  - descriptor build in the form the chains use (chained
    `_build_descs_chunked` calls, differenced);
  - partial query depths (search / hints / cascade / merge / init / full)
    with query descriptors cycling over 16 REVISIT-epoch scans against a
    bench.py-identical 4-lane fill store, so the cascade hint density
    matches the headline epochs;
  - append + window tail;
  - the headline itself re-measured in-session (step_chain_dyn t20/t132
    differenced) so the split can be checked against its sum.

Methodology: chained-dispatch differencing over a true device fetch. Run on
the GPU:

    timeout 3600 python scripts/headline_split_bench.py \
        > split.json 2>split.log
CPU smoke: JAX_PLATFORMS=cpu CONT2_SPLIT_SMOKE=1.

Output: ONE JSON line with per-stage ms/scan + the in-session headline.
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np


def log(msg):
    print(f"[split +{time.perf_counter() - T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


def main():
    import jax
    import jax.numpy as jnp
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from synth import make_world, render_scan

    from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
    from contour_context_tpu.db import (
        ContourDB, _append_impl, _build_descs_chunked, _check1_impl,
        _key_distances, _keys_to_q_layout, _query_step_impl,
        _search_impl, _select_hints, _update_window_impl)
    from contour_context_tpu.ops.descriptor import build_descriptor
    from contour_context_tpu.utils.io import pad_points

    smoke = os.environ.get("CONT2_SPLIT_SMOKE", "0") == "1"
    # CONT2_SPLIT_STD=0 skips the headline + small-store stage split
    # (rerun only the bigdb phase after a partial session)
    std = os.environ.get("CONT2_SPLIT_STD", "1") == "1"
    cfg = PipelineConfig(
        cm=ContourManagerConfig(max_points=16384 if smoke else 131072))
    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)

    K_FILL = 36 if smoke else 132
    K_SMALL = 20 if not smoke else 4
    N_LANES = 2 if smoke else 4   # bench.py lane geometry, 4 lanes = 528 fill

    HEAD_REPS = 1 if smoke else 3
    db = ContourDB(cfg,
                   capacity=N_LANES * K_FILL
                   + HEAD_REPS * (K_SMALL + K_FILL) + 8)

    def lane_poses(lane, dy=0.0):
        y0 = -300.0 + 120.0 * lane + dy
        return [(-264.0 + 4.0 * i, y0 + 0.5 * (i % 7), 0.05 * (i % 11))
                for i in range(K_FILL)]

    P_C = 12288

    def render_lane(lane, dy=0.0):
        rows = []
        for p in lane_poses(lane, dy):
            pts = render_scan(world, p, seed=int(rng.integers(1 << 30)))
            assert len(pts) <= P_C
            rows.append(pad_points(pts, P_C))
        return np.stack(rows)

    @jax.jit
    def devpad(c):
        pad = jnp.zeros((c.shape[0], cfg.cm.max_points - P_C, 4), c.dtype)
        pad = pad.at[:, :, 0].set(1e6)
        return jnp.concatenate([c, pad], axis=1)

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
    log(f"rendering {N_LANES} fill lanes + 1 epoch lane")
    clouds_fill = [render_lane(s) for s in range(N_LANES)]
    clouds_epoch = render_lane(1, dy=1.5)    # revisit of lane 1
    sw_th.join()
    log(f"mode switch paid ({switch_info['s']:.1f}s, overlapped)")

    log(f"fill: {N_LANES} x step_chain_dyn({K_FILL})")
    for s in range(N_LANES):
        base = s * K_FILL
        ts_fill = jax.device_put(
            np.arange(base, base + K_FILL, dtype=np.float32))
        h = db.step_chain_dyn_async(
            devpad(jax.device_put(clouds_fill[s])),
            list(range(base, base + K_FILL)), ts_fill)
        jax.block_until_ready(h.recs)
    n_fill = db.n
    log(f"fill done, store={n_fill}")

    pts_epoch = devpad(jax.device_put(clouds_epoch))

    # ---- in-session headline: t(K_SMALL)/t(K_FILL) dyn chains differenced --
    headline_ms = None
    if not smoke and std:
        staged_k = {k: db.stage_chain_k(k) for k in (K_SMALL, K_FILL)}
        # interleaved best-of-HEAD_REPS, bench.py-style: one-off fetch
        # noise can be the same order as the 112-scan signal, so a single
        # rep per length can difference negative. ts uploads pre-staged.
        plan = []
        base = n_fill
        for _ in range(HEAD_REPS):
            for k in (K_SMALL, K_FILL):
                plan.append((k, base, jax.device_put(
                    np.arange(base, base + K_FILL, dtype=np.float32))))
                base += k
        jax.block_until_ready([t for _, _, t in plan])
        best = {}
        for k, b, ts_k in plan:
            t0 = time.perf_counter()
            h = db.step_chain_dyn_async(pts_epoch,
                                        list(range(b, b + k)), ts_k,
                                        k_dev=staged_k[k])
            fetch1(h.recs)
            dt = time.perf_counter() - t0
            best[k] = dt if k not in best else min(best[k], dt)
            log(f"headline chain({k}): {dt * 1e3:.1f} ms")
        headline_ms = (best[K_FILL] - best[K_SMALL]) / (K_FILL - K_SMALL) * 1e3
        log(f"in-session headline: {headline_ms:.3f} ms/scan "
            f"(store now {db.n})")

    # stage-timing snapshot: the store as the headline epochs saw it
    store, keys_q, state = db.store, db.keys_q, db.state
    searchable = state[1]

    # 16 revisit-epoch query descriptors (rows 16..31 of the epoch lane ->
    # mid-lane scans, dense hint counts like the headline epochs)
    build16 = jax.jit(lambda p: _build_descs_chunked(p, cfg))
    descs16 = build16(pts_epoch[16:32])
    jax.block_until_ready(jax.tree.leaves(descs16)[0])

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

    split = {}

    def per_op(name, chained, k_small, k_big, per_iter_scans=1.0, *extra):
        t1 = timed(chained, *extra, k_small)
        tK = timed(chained, *extra, k_big)
        ms = (tK - t1) / (k_big - k_small) / per_iter_scans * 1e3
        log(f"{name}: {ms:.3f} ms/scan (t{k_small}={t1 * 1e3:.1f}, "
            f"t{k_big}={tK * 1e3:.1f})")
        split[name] = round(ms, 3)
        return ms

    # ---- descriptor build, SHIPPING vmapped-16 form ------------------------
    pts16 = pts_epoch[:16]

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_build16(pts, n_iter):
        def body(p, _):
            descs = _build_descs_chunked(p, cfg)
            return p * (1.0 + 1e-30 * descs.keys.sum()).astype(p.dtype), None
        p, _ = jax.lax.scan(body, pts, None, length=n_iter)
        return p[0, 0, 0]

    # NOTE: with the shipping desc_batch=1 this row measures the DEGENERATE
    # 16-singles-in-one-jit form (16 unrolled builds + a 25-leaf tree
    # concat), NOT the shipping chain build — desc_build_single below is the
    # shipping per-scan form; desc_batch_ab.py holds the full-chain A/B
    if std:
        per_op("desc_build_vmap16", chained_build16, 1, 5, 16.0, pts16)

    # unbatched single-scan build for comparison (the r3-recorded form)
    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_build1(pts, n_iter):
        def body(p, _):
            desc = build_descriptor(p, cfg.cm, cfg.gmm)
            return p * (1.0 + 1e-30 * desc.keys.sum()).astype(p.dtype), None
        p, _ = jax.lax.scan(body, pts, None, length=n_iter)
        return p[0, 0]

    if std:
        per_op("desc_build_single", chained_build1, 2, 10, 1.0, pts16[0])

    # ---- partial query depths at headline hint density ---------------------
    # each chain iteration queries descs16[i % 16] (fresh scan each step, so
    # the cascade load varies across iterations exactly like the headline's
    # sequential stream); the accumulator makes iterations data-dependent.
    # Depths run the PRODUCTION graph prefixes (db._query_step_impl's
    # trace-time `depth` gates) — the r4 split's hand-copied replica ran the
    # cascade unprefiltered at P_POT=512, i.e. NOT the shipping config.
    q_levels = tuple(cfg.db.q_levels)
    DEPTHS = ("search", "hints", "check1", "cascade", "merge", "init", "full")
    import dataclasses

    from contour_context_tpu.db import _search_cover2
    cfg_c2 = dataclasses.replace(
        cfg, db=dataclasses.replace(cfg.db, topk_strategy="cover2"))

    def query_depth(q, depth: str, store_=None, keys_q_=None, searchable_=None):
        store_ = store if store_ is None else store_
        keys_q_ = keys_q if keys_q_ is None else keys_q_
        searchable_ = searchable if searchable_ is None else searchable_
        if depth == "search_cover2":
            dist, idx, _qf = _search_cover2(keys_q_, q.keys, searchable_,
                                            q_levels, cfg.db.nnk)
            return dist.sum() + idx.sum()
        if depth == "full_cover2":
            return _query_step_impl(store_, q, searchable_, cfg_c2,
                                    keys_q_).sum()
        if depth == "dist":
            d2m, _ = _key_distances(keys_q_, q.keys, searchable_, q_levels)
            return d2m.sum()
        if depth == "tilemin":
            d2m, _ = _key_distances(keys_q_, q.keys, searchable_, q_levels)
            M = d2m.shape[-1]
            T = 128
            pad = (-M) % T
            if pad:
                d2m = jnp.pad(d2m, ((0, 0),) * (d2m.ndim - 1) + ((0, pad),),
                              constant_values=1e6)
            return d2m.reshape(d2m.shape[:-1]
                               + ((M + pad) // T, T)).min(-1).sum()
        if depth == "full":
            return _query_step_impl(store_, q, searchable_, cfg,
                                    keys_q_).sum()
        return _query_step_impl(store_, q, searchable_, cfg, keys_q_,
                                depth=depth)

    @functools.partial(jax.jit, static_argnames=("depth", "n_iter"))
    def chained_depth(descs, n_iter, depth):
        def body(i, acc):
            q = jax.tree.map(
                lambda a: jax.lax.dynamic_index_in_dim(
                    a, jnp.mod(i, 16), keepdims=False), descs)
            one = 1.0 + 1e-30 * acc
            q = jax.tree.map(
                lambda a: a * one.astype(a.dtype)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, q)
            return query_depth(q, depth).astype(jnp.float32)
        return jax.lax.fori_loop(0, n_iter, body, jnp.float32(0.0))

    prev = 0.0
    for depth in (DEPTHS if std else ()):
        def f(descs, n_iter, d=depth):
            return chained_depth(descs, n_iter, d)
        ms = per_op(f"query_depth_{depth}", f, 2, 18, 1.0, descs16)
        log(f"   stage delta [{depth}]: {ms - prev:+.3f} ms")
        split[f"delta_{depth}"] = round(ms - prev, 3)
        prev = ms

    # ---- append + window tail ----------------------------------------------
    tb = cfg.db.tb

    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_append(q, st0, n_iter):
        def body(carry, _):
            s, kq, ts_s, stt = carry
            s2, kq2, ts2, st2 = _append_impl(s, kq, ts_s, stt, q,
                                             ts_s[0] + 1.0)
            st2 = _update_window_impl(st2, ts2, ts2[0] + 1.0,
                                      tb.min_elapse, tb.max_elapse)
            st2 = st2.at[0].set(stt[0])       # keep the row fixed: no overflow
            return (s2, kq2, ts2, st2), None
        (s, kq, ts2, st2), _ = jax.lax.scan(
            body, (store, keys_q, db.ts_store, st0), None, length=n_iter)
        return st2[1] + ts2[0]

    q0 = jax.tree.map(lambda a: a[0], descs16)
    if std:
        per_op("append_window", chained_append, 2, 18, 1.0, q0, state)

    # hint-density audit of the 16 query descs (matches the headline epochs?)
    recs = np.asarray(jax.device_get(db.recs_store[:db.n]))
    hints_epoch = recs[n_fill:db.n, 6] if db.n > n_fill else recs[:0, 6]
    # cascade-pass funnel of the epoch scans (cols 7/8/9 = aft1/2/3): sizes
    # the pass1-prefilter design — if aft1 << n_hints, checks 2/3 can run on
    # a compacted survivor set instead of every hint
    funnel = {}
    for col, nm in ((7, "aft1"), (8, "aft2"), (9, "aft3")):
        v = recs[n_fill:db.n, col] if db.n > n_fill else recs[:0, col]
        if v.size:
            funnel[nm] = {"mean": round(float(v.mean()), 1),
                          "p90": float(np.percentile(v, 90)),
                          "max": float(v.max())}
    # bit-adjacent pair-pool audit at headline hint density: the TRUE
    # per-hint close-pair count (what ops/cascade.P_POT caps) over the 16
    # revisit queries' check-1 survivors — the evidence config.p_pot's
    # default rests on (the window stages' cost scales ~O(p_pot^2))
    @jax.jit
    def pool_sizes(q):
        gidx, seq_src, dist, valid = _search_impl(
            keys_q, q.keys, searchable, q_levels, cfg.db.nnk,
            cfg.db.topk_strategy)
        Q, A, Kk = gidx.shape
        lv = jnp.array(q_levels, jnp.int32)
        level_f = jnp.broadcast_to(lv[:, None, None], (Q, A, Kk)).reshape(-1)
        seq_tgt_f = jnp.broadcast_to(
            jnp.arange(A, dtype=jnp.int32)[None, :, None],
            (Q, A, Kk)).reshape(-1)
        HC = min(cfg.db.max_check_cands, Q * A * Kk)
        perm, hv, n_valid, _ = _select_hints(
            valid.reshape(-1), dist.reshape(-1), HC)
        g = gidx.reshape(-1)[perm]
        l = level_f[perm]
        ss = seq_src.reshape(-1)[perm]
        st_ = seq_tgt_f[perm]
        pass1 = _check1_impl(store, q, g, l, ss, st_, hv, cfg.db.cont_sim)
        gi = jnp.where(hv, g, 0)
        lc = jnp.clip(l, 0, store.nei_bit.shape[1] - 1)
        sc = jnp.clip(ss, 0, store.nei_bit.shape[2] - 1)
        tc = jnp.clip(st_, 0, q.nei_bit.shape[1] - 1)
        sb = store.nei_bit[gi, lc, sc].astype(jnp.int32)
        sv_ = store.nei_valid[gi, lc, sc]
        tb_ = q.nei_bit[lc, tc].astype(jnp.int32)
        tv_ = q.nei_valid[lc, tc]
        close = (jnp.abs(sb[:, :, None] - tb_[:, None, :]) <= 1) \
            & sv_[:, :, None] & tv_[:, None, :]
        pool = jnp.sum(close, axis=(1, 2)).astype(jnp.int32)
        return jnp.where(pass1, pool, -1)

    pools = (np.concatenate([
        np.asarray(jax.device_get(pool_sizes(
            jax.tree.map(lambda a: a[i], descs16)))) for i in range(16)])
        if std else np.zeros(0, np.int32))
    pools = pools[pools >= 0]
    pool_stats = None
    if pools.size:
        pool_stats = {"n_surv": int(pools.size),
                      "p50": float(np.percentile(pools, 50)),
                      "p90": float(np.percentile(pools, 90)),
                      "p99": float(np.percentile(pools, 99)),
                      "max": int(pools.max())}
        log(f"pair-pool audit over {pools.size} check-1 survivors: "
            f"p50={pool_stats['p50']:.0f} p99={pool_stats['p99']:.0f} "
            f"max={pool_stats['max']}")

    # ---- big-store phase: the SAME production depth gates against a tiled
    # city-scale store, to attribute the store-capacity-dependent query
    # floor. Tiles the deterministic
    # fill prefix exactly like bench.py's bigdb phase. Three probes:
    #   far   — a scan from an unfilled lane (TRUE zero-hint floor),
    #   epoch — a revisit-lane scan (bench.py's query_*scan_db_ms analog),
    #   dup   — a fill scan verbatim (distance-0 rows -> cap-dense hints).
    big_out = {}
    big_sizes = [int(x) for x in
                 os.environ.get("CONT2_SPLIT_BIGDB", "131072").split(",")
                 if x.strip() and int(x) > 0]
    if smoke:
        big_sizes = [4096] if big_sizes else []
    for n_db in big_sizes:
        log(f"bigdb phase: tiling store to {n_db} scans")
        reps_t = -(-n_db // n_fill)
        store_b = jax.tree.map(
            lambda a: jnp.tile(a[:n_fill],
                               (reps_t,) + (1,) * (a.ndim - 1))[:n_db],
            db.store)
        keys_q_b = jax.jit(functools.partial(
            _keys_to_q_layout, dtype=db.keys_q.dtype))(store_b.keys)
        searchable_b = jnp.int32(n_db - 32)
        kq_bf16 = keys_q_b.astype(jnp.bfloat16)

        probes = {
            "far": build_descriptor(devpad(jax.device_put(
                pad_points(render_scan(
                    world, (-264.0, -300.0 + 120.0 * 9, 0.0), seed=77),
                    P_C))[None])[0], cfg.cm, cfg.gmm),
            "epoch": jax.tree.map(lambda a: a[0], descs16),
            "dup": jax.tree.map(
                lambda a: a[4],
                build16(devpad(jax.device_put(clouds_fill[1][16:32])))),
        }
        # store/keys ride as EXPLICIT jit args: closing over the 4.8 GB
        # store would capture it as lowering constants, copying gigabytes
        # into the compiled program
        full_rec = jax.jit(lambda s, kq, q: _query_step_impl(
            s, q, searchable_b, cfg, kq))

        @functools.partial(jax.jit, static_argnames=("depth", "n_iter"))
        def chained_one_impl(s, kq, q, n_iter, depth):
            def body(acc, _):
                one = 1.0 + 1e-30 * acc
                qq = jax.tree.map(
                    lambda a: a * one.astype(a.dtype)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a, q)
                return query_depth(qq, depth, s, kq,
                                   searchable_b).astype(jnp.float32), None
            acc, _ = jax.lax.scan(body, jnp.float32(0.0), None,
                                  length=n_iter)
            return acc

        def chained_one(q, n_iter, depth, bf16=False):
            return chained_one_impl(store_b, kq_bf16 if bf16 else keys_q_b,
                                    q, n_iter, depth)

        kb_small, kb_big = (1, 3) if smoke else (2, 26)
        for pname, plan in (
                ("far", ("dist", "tilemin", "search", "hints", "check1",
                         "cascade", "merge", "init", "full")),
                ("epoch", ("search", "full")),
                ("dup", ("search", "hints", "check1", "cascade", "merge",
                         "init", "full"))):
            q = probes[pname]
            rec = np.asarray(jax.device_get(full_rec(store_b, keys_q_b, q)))
            big_out[f"{n_db}_{pname}_funnel"] = {
                "n_hints": int(rec[6]), "aft1": int(rec[7]),
                "aft2": int(rec[8]), "aft3": int(rec[9])}
            log(f"bigdb {n_db} probe {pname}: hints={int(rec[6])} "
                f"aft1={int(rec[7])} aft2={int(rec[8])} aft3={int(rec[9])}")
            prev = 0.0
            for depth in plan:
                def f(qq, n_iter, d=depth):
                    return chained_one(qq, n_iter, d)
                ms = per_op(f"big{n_db}_{pname}_{depth}", f,
                            kb_small, kb_big, 1.0, q)
                log(f"   bigdb delta [{pname}/{depth}]: {ms - prev:+.3f} ms")
                big_out[f"{n_db}_{pname}_delta_{depth}"] = round(ms - prev, 3)
                prev = ms
        # A/B rows (not in the delta chains): the fused cover2 search
        # lowering and bf16 search-layout keys (the open PARITY claim)
        for pname, depth, bf16 in (
                ("far", "search_cover2", False),
                ("far", "full_cover2", False),
                ("dup", "full_cover2", False),
                ("far", "dist", True),
                ("far", "search", True),
                ("far", "search_cover2", True)):
            def fb(qq, n_iter, d=depth, b=bf16):
                return chained_one(qq, n_iter, d, bf16=b)
            per_op(f"big{n_db}_{pname}_{depth}" + ("_bf16" if bf16 else ""),
                   fb, kb_small, kb_big, 1.0, probes[pname])
        del store_b, keys_q_b, kq_bf16, probes, full_rec
        import gc
        gc.collect()

    total = (split["desc_build_vmap16"] + split["query_depth_full"]
             + split["append_window"]) if std else None
    out = {
        "metric": "headline stage split (shipping chain config, ms/scan)",
        "headline_in_session_ms": (round(headline_ms, 3)
                                   if headline_ms is not None else None),
        "split_sum_ms": round(total, 3) if total is not None else None,
        "split": split,
        "store_scans": int(n_fill),
        "hints_per_scan_epoch": (
            {"mean": round(float(hints_epoch.mean()), 1),
             "p50": float(np.percentile(hints_epoch, 50)),
             "p90": float(np.percentile(hints_epoch, 90))}
            if hints_epoch.size else None),
        "pass_funnel_epoch": funnel or None,
        "pair_pool_pass1": pool_stats,
        "bigdb": big_out or None,
        "elapsed_s": round(time.perf_counter() - T0, 1),
    }
    print(json.dumps(out), flush=True)
    log("done")


if __name__ == "__main__":
    main()
