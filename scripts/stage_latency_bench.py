"""Stage-isolation device-time breakdown of the fused per-scan step.

Times PARTIAL DEPTHS of the query pipeline (search -> hint selection ->
cascade -> proposal merge -> tidy+GMM-init -> fine optimize) plus the
descriptor build and the append+window tail, each as a chained
single-dispatch measurement (lax.scan of K data-dependent iterations,
differenced over a device_get). Successive depth differences give per-stage
cost.

The partial-depth body REPLICATES db._query_step_impl's structure (kept in
sync by eye; this is a diagnostic, the production path is the real thing).

Run on the GPU:
    timeout 1800 python scripts/stage_latency_bench.py > stage.log 2>&1
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
    ap.add_argument("--scans", type=int, default=132)
    ap.add_argument("--chain", type=int, default=21)
    ap.add_argument("--max-points", type=int, default=131072)
    args = ap.parse_args()
    K = args.chain

    import jax
    import jax.numpy as jnp
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from synth import make_world, render_scan

    from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
    from contour_context_tpu.db import (
        ContourDB, _append_impl, _cascade_chunked, _gather_gmm_impl,
        _search_impl, _select_hints, _update_window_impl)
    from contour_context_tpu.ops.candidate import (merge_proposals,
                                                   tidy_candidates)
    from contour_context_tpu.ops.descriptor import build_descriptor
    from contour_context_tpu.ops.gmm import (gmm_from_desc, init_correlation,
                                             optimize_correlation)
    from contour_context_tpu.utils.io import pad_points

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=args.max_points))
    rng = np.random.default_rng(0)
    world = make_world(1, n_structs=300, extent=400.0)
    n_out = args.scans // 2
    poses = [(4.0 * i, 0.5 * (i % 7), 0.05 * (i % 11)) for i in range(n_out)]
    poses += [(4.0 * (2 * n_out - 2 - i), 0.8, 0.1)
              for i in range(n_out, args.scans)]
    print("rendering", flush=True)
    clouds = np.stack(
        [pad_points(render_scan(world, p, seed=int(rng.integers(1 << 30))),
                    cfg.cm.max_points) for p in poses])

    db = ContourDB(cfg, capacity=args.scans + 8)
    ts = np.arange(args.scans, dtype=np.float32)
    print("filling store (step_chain)", flush=True)
    h = db.step_chain_async(jax.device_put(clouds), list(range(args.scans)),
                            jax.device_put(ts))
    jax.block_until_ready(h.recs)

    pts0 = jax.device_put(clouds[args.scans // 4])
    q0 = build_descriptor(pts0, cfg.cm, cfg.gmm)
    store, keys_q, state = db.store, db.keys_q, db.state

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

    def perturb(q, s):
        one = 1.0 + 1e-30 * s
        return jax.tree.map(
            lambda a: a * one.astype(a.dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, q)

    # ---- descriptor build ---------------------------------------------------
    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_build(pts, n_iter):
        def body(p, _):
            desc = build_descriptor(p, cfg.cm, cfg.gmm)
            return p * (1.0 + 1e-30 * desc.keys.sum()).astype(p.dtype), None
        p, _ = jax.lax.scan(body, pts, None, length=n_iter)
        return p[0, 0]

    per_op("descriptor build", chained_build, pts0)

    # ---- partial query depths ----------------------------------------------
    # replicates db._query_step_impl stage by stage; each depth returns a
    # scalar keeping every computed value live
    def query_depth(q, searchable_n, depth: str):
        q_levels = tuple(cfg.db.q_levels)
        N = store.keys.shape[0]
        gidx, seq_src, dist, valid = _search_impl(
            keys_q, q.keys, searchable_n, q_levels, cfg.db.nnk,
            cfg.db.topk_strategy)
        if depth == "search":
            return dist.sum() + gidx.sum()
        Q, A, Kk = gidx.shape
        lv = jnp.array(q_levels, jnp.int32)
        level_f = jnp.broadcast_to(lv[:, None, None], (Q, A, Kk)).reshape(-1)
        seq_tgt_f = jnp.broadcast_to(
            jnp.arange(A, dtype=jnp.int32)[None, :, None],
            (Q, A, Kk)).reshape(-1)
        gidx_f = gidx.reshape(-1)
        seq_src_f = seq_src.reshape(-1)
        HC = min(cfg.db.max_check_cands, Q * A * Kk)
        perm, hv, n_valid, ovf = _select_hints(
            valid.reshape(-1), dist.reshape(-1), HC)
        if depth == "hints":
            return perm.sum() + n_valid
        res = _cascade_chunked(
            store, q, gidx_f[perm], level_f[perm], seq_src_f[perm],
            seq_tgt_f[perm], hv, n_valid, cfg.thres_lb, cfg.db.cont_sim,
            cfg.db.cascade_chunk)
        if depth == "cascade":
            return (res.T_delta.sum() + res.pass3.sum()
                    + res.pair_area_perc.sum())
        st = merge_proposals(
            res.pass3, gidx_f[perm], res.T_delta, res.pair_valid,
            res.pair_level, res.pair_seq_src, res.pair_seq_tgt,
            res.pair_area_perc, n_cand_max=cfg.db.max_cand_poses,
            n_pass_max=cfg.db.max_pass_hints)
        if depth == "merge":
            return st.prop_T.sum() + st.n_cand
        tidy = tidy_candidates(
            st, cfg.thres_lb.sim_post.area_perc,
            cfg.thres_lb.sim_post.neg_est_dist,
            cfg.cm.n_row, cfg.cm.n_col, cfg.cm.reso_row, cfg.cm.reso_col)
        cg = jnp.clip(st.cand_gidx, 0, N - 1)
        src_gmm = _gather_gmm_impl(store, cg, tuple(cfg.gmm.levels),
                                   cfg.gmm.max_gmm_ellipses)
        tgt_gmm = gmm_from_desc(q, cfg.gmm)
        corr0, selp = init_correlation(src_gmm, tgt_gmm, tidy.T_sel,
                                       scale=cfg.gmm.cov_dilate_scale)
        if depth == "init":
            return corr0.sum() + tidy.T_sel.sum()
        keep = tidy.alive & (corr0 >= cfg.thres_lb.sim_post.correlation)
        C = st.cand_gidx.shape[0]
        F = min(cfg.db.max_fine_opt, C)
        rank = jnp.where(keep, corr0, -jnp.inf)
        topv, topi = jax.lax.top_k(rank, F)
        src_f = jax.tree.map(lambda a: a[topi], src_gmm)
        corr_f, T_f = optimize_correlation(
            src_f, tgt_gmm, tidy.T_sel[topi], selp[topi],
            scale=cfg.gmm.cov_dilate_scale, iters=cfg.gmm.gn_iters)
        return corr_f.sum() + T_f.sum()

    @functools.partial(jax.jit, static_argnames=("depth", "n_iter"))
    def chained_depth(q, n_iter, depth):
        def body(c, _):
            s = query_depth(c, state[1], depth)
            return perturb(c, s), s
        c, ss = jax.lax.scan(body, q, None, length=n_iter)
        return ss[-1]

    prev = 0.0
    for depth in ("search", "hints", "cascade", "merge", "init", "full"):
        def f(q, n_iter, d=depth):
            return chained_depth(q, n_iter, d)
        ms = per_op(f"query depth={depth}", f, q0)
        print(f"   stage delta [{depth}]: {ms - prev:+.3f} ms", flush=True)
        prev = ms

    # ---- append + window tail ----------------------------------------------
    @functools.partial(jax.jit, static_argnames=("n_iter",))
    def chained_append(q, st0, n_iter):
        tb = cfg.db.tb

        def body(carry, _):
            s, ts_s, stt = carry
            s2, kq2, ts2, st2 = _append_impl(s, keys_q, ts_s,
                                             stt, q, ts_s[0] + 1.0)
            st2 = _update_window_impl(st2, ts2, ts2[0] + 1.0,
                                      tb.min_elapse, tb.max_elapse)
            st2 = st2.at[0].set(stt[0])       # keep the row fixed: no overflow
            return (s2, ts2, st2), None
        (s, ts2, st2), _ = jax.lax.scan(
            body, (store, db.ts_store, st0), None, length=n_iter)
        return st2[1] + ts2[0]

    per_op("append+window", chained_append, q0, state)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
