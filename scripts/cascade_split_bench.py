"""Per-chunk cost attribution of the check cascade (ops/cascade.run_cascade).

The cascade runs in chunks of 128 live hints (db._cascade_chunked). Every
op in run_cascade is fixed-shape and data-independent (no data-dependent
trip counts), so its per-chunk cost can be attributed on SYNTHETIC hint
rows against a tiny store — no 660-render fill needed.

Measures, all chained-dispatch differenced, at the shipping chunk width
W=128:

  - partial depths of a faithful run_cascade replica:
      check1  anchor gathers + checkSim
      bits    BCI bitsets + shifted overlaps (check 2 gates)
      sort    close-pair mask + the (W, M*M) 2-operand angle sort
      window  the (W, P_POT^2) circular window count + argmax
      members window extraction + packed pair-identity gathers
      tab     check-3 stats-table pack + 2 per-pair gathers + checkSim
      full    shaft + orientation + umeyama (== the real kernel's cost
              envelope; parity of the real kernel is pinned by the oracle
              suite, this replica exists only to host depth gates)
  - the REAL run_cascade at P_POT in {512, 256, 128} and W in {128, 64}
    (module-constant patch; pot_overflow tells when 512 actually binds).

Run on the GPU:
    timeout 2400 python scripts/cascade_split_bench.py > casc.json \
        2>casc.log
CPU smoke: JAX_PLATFORMS=cpu CONT2_CASC_SMOKE=1 (tiny chain).
"""

import functools
import json
import math
import os
import sys
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np


def log(msg):
    print(f"[casc +{time.perf_counter() - T0:.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


def main():
    import jax
    import jax.numpy as jnp

    smoke = os.environ.get("CONT2_CASC_SMOKE", "0") == "1"
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from synth import make_world, render_scan

    from contour_context_tpu import ops
    from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
    from contour_context_tpu.db import (ContourDB,
                                        _gather_and_cascade_impl)
    from contour_context_tpu.ops import cascade as casc_mod
    from contour_context_tpu.ops.cascade import (_bits_from_nei, _clamp_ang,
                                                 check_sim_batched)
    from contour_context_tpu.ops.descriptor import build_descriptor
    from contour_context_tpu.utils.io import pad_points

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    db = ContourDB(cfg, capacity=16)
    for i in range(8):
        pts = render_scan(world, (10.0 * i, 0.0, 0.0), seed=500 + i)
        desc = build_descriptor(pad_points(pts, cfg.cm.max_points),
                                cfg.cm, cfg.gmm)
        db.add_scan(desc, i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    q = build_descriptor(pad_points(
        render_scan(world, (10.5, 0.8, 0.2), seed=900), cfg.cm.max_points),
        cfg.cm, cfg.gmm)
    store = db.store

    W = 32 if smoke else 128
    # synthetic hint rows: cycle the 8 stored scans x 6 anchors on level 1/2
    gidx = jnp.asarray(np.arange(W) % 8, jnp.int32)
    level = jnp.asarray(1 + (np.arange(W) % 2), jnp.int32)
    seq_src = jnp.asarray(np.arange(W) % 6, jnp.int32)
    seq_tgt = jnp.asarray((np.arange(W) // 2) % 6, jnp.int32)
    hv = jnp.ones((W,), bool)

    t0 = time.perf_counter()
    jax.device_get(jnp.zeros(4) + 1.0)
    log(f"mode switch paid ({time.perf_counter() - t0:.0f}s)")

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

    K_SMALL, K_BIG = (1, 3) if smoke else (2, 18)
    out = {"W": W}

    def per_op(name, chained, *extra):
        t1 = timed(chained, *extra, K_SMALL)
        tK = timed(chained, *extra, K_BIG)
        ms = (tK - t1) / (K_BIG - K_SMALL) * 1e3
        log(f"{name}: {ms:.3f} ms/chunk (t{K_SMALL}={t1 * 1e3:.1f}, "
            f"t{K_BIG}={tK * 1e3:.1f})")
        out[name] = round(ms, 4)
        return ms

    # ---- depth-gated replica of run_cascade (cost envelope only) ----------
    from contour_context_tpu.config import DIST_BIN_LAYERS
    from contour_context_tpu.db import _tab_from

    P_MAX = casc_mod.P_MAX
    P_POT = casc_mod.P_POT
    SHAFT_TOP = casc_mod.SHAFT_TOP
    ANG_RANGE = casc_mod.ANG_RANGE
    thres_lb = cfg.thres_lb
    cont_sim = cfg.db.cont_sim

    def cascade_depth(q_in, depth: str):
        H = W
        gi = jnp.where(hv, gidx, 0)
        lvl = jnp.clip(level, 0, store.cnt.shape[1] - 1)
        ss = jnp.clip(seq_src, 0, store.cnt.shape[2] - 1)
        st = jnp.clip(seq_tgt, 0, q_in.cnt.shape[1] - 1)
        at_src = lambda a: a[gi, lvl, ss]
        at_tgt = lambda a: a[lvl, st]
        pass1 = hv & check_sim_batched(
            at_src(store.cnt).astype(jnp.float32), at_src(store.eig_vals),
            at_src(store.vol3_mean), at_src(store.com_r),
            at_tgt(q_in.cnt).astype(jnp.float32), at_tgt(q_in.eig_vals),
            at_tgt(q_in.vol3_mean), at_tgt(q_in.com_r), cont_sim)
        if depth == "check1":
            return pass1.sum().astype(jnp.float32)
        src_nei = dict(valid=at_src(store.nei_valid),
                       level=at_src(store.nei_level).astype(jnp.int32),
                       seq=at_src(store.nei_seq).astype(jnp.int32),
                       bit=at_src(store.nei_bit).astype(jnp.int32),
                       theta=at_src(store.nei_theta))
        tgt_nei = dict(valid=at_tgt(q_in.nei_valid),
                       level=at_tgt(q_in.nei_level).astype(jnp.int32),
                       seq=at_tgt(q_in.nei_seq).astype(jnp.int32),
                       bit=at_tgt(q_in.nei_bit).astype(jnp.int32),
                       theta=at_tgt(q_in.nei_theta))
        M = src_nei["bit"].shape[1]
        bits_s = _bits_from_nei(src_nei["bit"], src_nei["valid"])
        bits_t = _bits_from_nei(tgt_nei["bit"], tgt_nei["valid"])
        shl = jnp.concatenate([jnp.zeros((H, 1), bool), bits_s[:, :-1]], axis=1)
        shr = jnp.concatenate([bits_s[:, 1:], jnp.zeros((H, 1), bool)], axis=1)
        and1 = jnp.sum(bits_s & bits_t, axis=1)
        and2 = jnp.sum(shl & bits_t, axis=1)
        and3 = jnp.sum(shr & bits_t, axis=1)
        ovlp = (and1 + and2 + and3).astype(jnp.int32)
        if depth == "bits":
            return (pass1.sum() + ovlp.sum()).astype(jnp.float32)
        close = (jnp.abs(src_nei["bit"][:, :, None]
                         - tgt_nei["bit"][:, None, :]) <= 1) \
            & src_nei["valid"][:, :, None] & tgt_nei["valid"][:, None, :]
        orie = _clamp_ang(tgt_nei["theta"][:, None, :]
                          - src_nei["theta"][:, :, None])
        orie = jnp.where(close, orie, jnp.inf).transpose(0, 2, 1) \
            .reshape(H, M * M)
        p_flat = jnp.broadcast_to(
            jnp.arange(M * M, dtype=jnp.int32)[None], (H, M * M))
        sv, s_flat = jax.lax.sort((orie, p_flat), dimension=1, num_keys=1,
                                  is_stable=True)
        sv, s_flat = sv[:, :P_POT], s_flat[:, :P_POT]
        n_pot = jnp.sum(jnp.isfinite(sv), axis=1).astype(jnp.int32)
        if depth == "sort":
            return (sv[:, 0].sum() + s_flat[:, 0].sum()
                    + n_pot.sum()).astype(jnp.float32)

        def window_counts(vals, n):
            hi = vals + ANG_RANGE
            c_main = jnp.sum(vals[None, :] <= hi[:, None], axis=1)
            c_wrap = jnp.sum(vals[None, :] <= (hi - 2 * math.pi)[:, None],
                             axis=1)
            idx = jnp.arange(vals.shape[0])
            cnt = jnp.minimum(c_main, n) - idx + jnp.minimum(c_wrap, n)
            return jnp.where(idx < n, cnt, 0)

        counts = jax.vmap(window_counts)(sv, n_pot)
        longest = jnp.maximum(jnp.max(counts, axis=1), 1).astype(jnp.int32)
        best_beg = jnp.argmax(counts, axis=1).astype(jnp.int32)
        if depth == "window":
            return (longest.sum() + best_beg.sum()).astype(jnp.float32)
        win_pos = (best_beg[:, None] + jnp.arange(P_MAX - 1)[None, :])
        win_pos = win_pos % jnp.maximum(n_pot, 1)[:, None]
        g_flat = jnp.take_along_axis(s_flat, win_pos, axis=1)
        g_src_slot = g_flat % M
        g_tgt_slot = g_flat // M
        src_ls = src_nei["level"] * 64 + src_nei["seq"]
        g_ls = jnp.take_along_axis(src_ls, g_src_slot, axis=1)
        pt = jnp.take_along_axis(tgt_nei["seq"], g_tgt_slot, axis=1)
        if depth == "members":
            return (g_ls.sum() + pt.sum()).astype(jnp.float32)
        pl = g_ls // 64
        ps = g_ls % 64
        pair_level = jnp.concatenate([pl, level[:, None]], axis=1)
        pair_seq_src = jnp.concatenate([ps, seq_src[:, None]], axis=1)
        pair_seq_tgt = jnp.concatenate([pt, seq_tgt[:, None]], axis=1)
        src_tab = _tab_from(store, gi)
        qt = _tab_from(q_in, None)
        tgt_tab = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (H,) + a.shape), qt)
        J = src_tab["cnt"].shape[2]

        def pack_tab(tab):
            return jnp.stack([
                tab["cnt"], tab["eig"][..., 0], tab["eig"][..., 1], tab["h"],
                tab["comr"], tab["mean"][..., 0], tab["mean"][..., 1],
                tab["vec1"][..., 0], tab["vec1"][..., 1],
                tab["ecc"].astype(jnp.float32), tab["perc"],
                tab["ok"].astype(jnp.float32)], axis=-1)

        def gather_tab(packed, lev, seq):
            li = jnp.clip(lev - 1, 0, packed.shape[1] - 1)
            sj = jnp.clip(seq, 0, J - 1)
            g = packed[jnp.arange(H)[:, None], li, sj]
            return g

        gs = gather_tab(pack_tab(src_tab), pair_level, pair_seq_src)
        gt = gather_tab(pack_tab(tgt_tab), pair_level, pair_seq_tgt)
        indiv = check_sim_batched(
            gs[..., 0], jnp.stack([gs[..., 1], gs[..., 2]], -1), gs[..., 3],
            gs[..., 4], gt[..., 0], jnp.stack([gt[..., 1], gt[..., 2]], -1),
            gt[..., 3], gt[..., 4], cont_sim)
        if depth == "tab":
            return (indiv.sum() + gs.sum() + gt.sum()).astype(jnp.float32)
        # full: run the REAL kernel (shaft + orientation + umeyama included)
        res = _gather_and_cascade_impl(store, q_in, gidx, level, seq_src,
                                       seq_tgt, hv, thres_lb, cont_sim)
        return (res.T_delta.sum() + res.pass3.sum()
                + res.pair_area_perc.sum()).astype(jnp.float32)

    @functools.partial(jax.jit, static_argnames=("depth", "n_iter"))
    def chained_depth(q_in, n_iter, depth):
        def body(acc, _):
            one = 1.0 + 1e-30 * acc
            qq = jax.tree.map(
                lambda a: a * one.astype(a.dtype)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, q_in)
            return cascade_depth(qq, depth), None
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n_iter)
        return acc

    prev = 0.0
    for depth in ("check1", "bits", "sort", "window", "members", "tab",
                  "full"):
        def f(q_in, n_iter, d=depth):
            return chained_depth(q_in, n_iter, d)
        ms = per_op(f"depth_{depth}", f, q)
        log(f"   delta [{depth}]: {ms - prev:+.3f} ms/chunk")
        out[f"delta_{depth}"] = round(ms - prev, 4)
        prev = ms

    # ---- P_POT sensitivity of the REAL kernel ------------------------------
    @functools.partial(jax.jit, static_argnames=("n_iter", "tag"))
    def chained_real(q_in, n_iter, tag):
        def body(acc, _):
            one = 1.0 + 1e-30 * acc
            qq = jax.tree.map(
                lambda a: a * one.astype(a.dtype)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, q_in)
            res = _gather_and_cascade_impl(store, qq, gidx, level, seq_src,
                                           seq_tgt, hv, thres_lb, cont_sim)
            return (res.T_delta.sum() + res.pass3.sum()
                    + jnp.sum(res.pot_overflow).astype(jnp.float32)), None
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n_iter)
        return acc

    # ---- W (chunk width) sensitivity of the REAL kernel at P_POT=512 -------
    # per-scan cascade cost = ceil(aft1/W) * c(W); c(W) = a + b*W means wider
    # chunks amortize the fixed overhead `a` at dense loads but cost more at
    # KITTI-matched loads (1 live chunk either way) — measure both terms
    for W2 in ((256,) if not smoke else ()):
        gidx2 = jnp.asarray(np.arange(W2) % 8, jnp.int32)
        level2 = jnp.asarray(1 + (np.arange(W2) % 2), jnp.int32)
        ss2 = jnp.asarray(np.arange(W2) % 6, jnp.int32)
        st2 = jnp.asarray((np.arange(W2) // 2) % 6, jnp.int32)

        @functools.partial(jax.jit, static_argnames=("n_iter",))
        def chained_w2(q_in, n_iter):
            def body(acc, _):
                one = 1.0 + 1e-30 * acc
                qq = jax.tree.map(
                    lambda a: a * one.astype(a.dtype)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a, q_in)
                res = _gather_and_cascade_impl(
                    store, qq, gidx2, level2, ss2, st2,
                    jnp.ones((W2,), bool), thres_lb, cont_sim)
                return (res.T_delta.sum() + res.pass3.sum()), None
            acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n_iter)
            return acc

        per_op(f"real_W{W2}_PPOT{casc_mod.P_POT}", chained_w2, q)

    pot0 = casc_mod.P_POT
    try:
        for pot in (512, 256, 128) if not smoke else (64,):
            casc_mod.P_POT = pot
            # run_cascade reads P_POT at trace time and is itself jitted:
            # clear its trace cache so the patched constant takes effect,
            # and key the chain on `tag` so IT re-traces too
            casc_mod.run_cascade.clear_cache()

            def f(q_in, n_iter, p=pot):
                return chained_real(q_in, n_iter, p)

            per_op(f"real_W{W}_PPOT{pot}", f, q)
    finally:
        casc_mod.P_POT = pot0
        casc_mod.run_cascade.clear_cache()

    print(json.dumps(out), flush=True)
    log("done")


if __name__ == "__main__":
    main()
