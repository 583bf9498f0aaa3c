"""Device-time benchmark of the city-scale key search variants.

Every variant is timed by chaining K data-dependent iterations inside ONE
jitted lax.scan, syncing on a real device_get, and differencing two K values
— dispatch and fetch overhead cancel, leaving device time.

Variants (select with --variants, comma-separated, in run order):
  bur     sanity check: block_until_ready vs device_get on a K-chain
  floor   read floor: running min over the flat key matrix (f32 + bf16)
  dist    masked distance matrix only (db._key_distances, materializing)
  search  db._search_impl (two-stage exact _topk_min, strategy "block":
          per-4096-block min-k)
  searchcover  db._search_impl with topk strategy "cover" (tile-min cover:
          stage 1 is a pure min-reduce — no per-block sort)
  searchbf16  same as search with bfloat16 keys
  searchfresh  same, but the chain body perturbs db_keys by a runtime
          factor that is exactly 1.0f, so the (N,L,A,D)->(Q,N*A,D) layout
          gather/transpose inside _key_distances is loop-carried and CANNOT
          be hoisted out of the scan. search-vs-searchfresh isolates how
          much a maintained query-layout store saves.

Each variant compiles two graphs (K=1 and K=--chain); the persistent compile
cache (utils/compile_cache.py) makes reruns cheap. Run on the GPU:

    timeout 1800 python scripts/search_latency_bench.py \
        --variants floor,search > slb.log 2>&1
"""

import argparse
import functools
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=131072, help="scans in the store")
    ap.add_argument("--chain", type=int, default=101,
                    help="long-chain length K (per-op = (tK - t1)/(K-1))")
    ap.add_argument("--nnk", type=int, default=50)
    ap.add_argument("--variants", default="bur,floor,dist,search")
    args = ap.parse_args()
    variants = args.variants.split(",")

    import jax
    import jax.numpy as jnp
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    from contour_context_tpu.db import _key_distances, _search_impl

    N, L, A, D = args.n, 6, 6, 10
    QL = (1, 2, 3)
    K = args.chain
    rng = np.random.default_rng(0)
    kb = rng.uniform(0.1, 5.0, (N, L, A, D)).astype(np.float32)
    qk = rng.uniform(0.1, 5.0, (L, A, D)).astype(np.float32)

    db_keys = jax.device_put(jnp.asarray(kb))          # scan-major
    # the production store: the maintained (L, D, N*A) search layout
    kq = jax.device_put(jnp.asarray(np.ascontiguousarray(
        kb.transpose(1, 3, 0, 2).reshape(L, D, N * A))))
    q = jnp.asarray(qk, jnp.float32)
    sn = jnp.int32(N)

    def timed(fn, *fn_args):
        r = fn(*fn_args)
        jax.device_get(r)                       # compile + sync
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = fn(*fn_args)
            jax.device_get(r)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    def per_op(name, chained, *extra):
        t1 = timed(chained, *extra, 1)
        tK = timed(chained, *extra, K)
        ms = (tK - t1) / (K - 1) * 1e3
        print(f"{name}: per-op {ms:.3f} ms  (t1={t1 * 1e3:.1f} ms, "
              f"t{K}={tK * 1e3:.1f} ms)", flush=True)
        return ms

    if "bur" in variants:
        @functools.partial(jax.jit, static_argnames=("n_iter",))
        def chained_full(qq, keys, n_iter):
            def body(c, _):
                g, s, d, v = _search_impl(keys, c, sn, QL, args.nnk)
                return c * (1.0 + 1e-30 * d.min()), None
            c, _ = jax.lax.scan(body, qq, None, length=n_iter)
            return c[0, 0, 0]

        r = chained_full(q, kq, K)
        jax.device_get(r)
        t0 = time.perf_counter()
        r = chained_full(q, kq, K)
        jax.block_until_ready(r)
        t_bur = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ = jax.device_get(r)
        t_get = time.perf_counter() - t0
        print(f"bur-check chain{K}: block_until_ready={t_bur * 1e3:.1f} ms, "
              f"then device_get={t_get * 1e3:.1f} ms "
              f"(device_get >> BUR means BUR did not sync)", flush=True)

    if "floor" in variants:
        flat32 = db_keys.reshape(-1)
        flat16 = flat32.astype(jnp.bfloat16)

        @functools.partial(jax.jit, static_argnames=("n_iter",))
        def chained_min(x, n_iter):
            def body(c, _):
                return c + 1e-30 * x.min().astype(jnp.float32), None
            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=n_iter)
            return c
        per_op("floor[f32 read-min]", chained_min, flat32)
        per_op("floor[bf16 read-min]", chained_min, flat16)

    if "dist" in variants:
        @functools.partial(jax.jit, static_argnames=("n_iter",))
        def chained_dist(qq, keys, n_iter):
            def body(c, _):
                d2m, _qf = _key_distances(keys, c, sn, QL)
                return c * (1.0 + 1e-30 * d2m.min()), None
            c, _ = jax.lax.scan(body, qq, None, length=n_iter)
            return c[0, 0, 0]
        per_op("dist-only[f32]", chained_dist, q, kq)

    if "search" in variants or "searchbf16" in variants:
        @functools.partial(jax.jit, static_argnames=("n_iter",))
        def chained_search(qq, keys, n_iter):
            def body(c, _):
                g, s, d, v = _search_impl(keys, c, sn, QL, args.nnk)
                return c * (1.0 + 1e-30 * d.min()), None
            c, _ = jax.lax.scan(body, qq, None, length=n_iter)
            return c[0, 0, 0]
        if "search" in variants:
            per_op("search[f32 block]", chained_search, q, kq)
        if "searchbf16" in variants:
            per_op("search[bf16 block]", chained_search, q,
                   kq.astype(jnp.bfloat16))

    if "searchcover" in variants or "searchcoverbf16" in variants:
        @functools.partial(jax.jit, static_argnames=("n_iter",))
        def chained_search_cover(qq, keys, n_iter):
            def body(c, _):
                g, s, d, v = _search_impl(keys, c, sn, QL, args.nnk,
                                          strategy="cover")
                return c * (1.0 + 1e-30 * d.min()), None
            c, _ = jax.lax.scan(body, qq, None, length=n_iter)
            return c[0, 0, 0]
        if "searchcover" in variants:
            per_op("search[f32 cover]", chained_search_cover, q, kq)
        if "searchcoverbf16" in variants:
            per_op("search[bf16 cover]", chained_search_cover, q,
                   kq.astype(jnp.bfloat16))

    if "searchfresh" in variants or "searchfreshcover" in variants:
        @functools.partial(jax.jit, static_argnames=("n_iter", "strategy"))
        def chained_search_fresh(qq, keys, n_iter, strategy="block"):
            def body(carry, _):
                c, ks = carry
                g, s, d, v = _search_impl(ks, c, sn, QL, args.nnk,
                                          strategy=strategy)
                one = (1.0 + 1e-30 * d.min()).astype(ks.dtype)
                # single-element in-place scatter: loop-carries ks without
                # rewriting the store (a full ks*one would add 2x188 MB of
                # confounding traffic per iteration)
                return (c * one.astype(jnp.float32),
                        ks.at[0, 0, 0].multiply(one)), None
            (c, _ks), _ = jax.lax.scan(body, (qq, keys), None, length=n_iter)
            return c[0, 0, 0]
        if "searchfresh" in variants:
            per_op("search[f32 fresh-keys]", chained_search_fresh, q, kq)
        if "searchfreshcover" in variants:
            def fresh_cover(qq, keys, n_iter):
                return chained_search_fresh(qq, keys, n_iter, "cover")
            per_op("search[f32 fresh-keys cover]", fresh_cover, q, kq)

    if ("transp" in variants or "distkt" in variants
            or "searchkt" in variants):
        # isolate the production layout question: `transp` is the
        # (N,L,A,D)->(Q,D,N*A) transpose alone (loop-carried, so it cannot
        # hoist); `distkt`/`searchkt` start from a PRE-transposed key store
        # — the cost the DB would pay per query if it maintained the
        # search-layout copy incrementally at append time.
        QLa = jnp.array(QL, jnp.int32)
        kt_host = np.ascontiguousarray(
            kb[:, list(QL)].transpose(1, 3, 0, 2).reshape(
                len(QL), D, N * A))
        kt_dev = jax.device_put(jnp.asarray(kt_host))
        qsel = q[QLa]                                       # (Q, A, D)
        nq = len(QL)

        def dist_from_kt(ks, qf):
            d2 = jnp.zeros((nq, A, N * A), jnp.float32)
            for d in range(D):
                diff = (ks[:, d, :][:, None, :].astype(jnp.float32)
                        - qf[:, :, d][:, :, None])
                d2 = d2 + diff * diff
            row_valid = jnp.abs(ks.astype(jnp.float32)).sum(1) > 0
            scan_of_row = jnp.repeat(
                jnp.arange(N, dtype=jnp.int32), A)[None]
            ok = (row_valid & (scan_of_row < sn))[:, None, :]
            return jnp.where(ok, d2, 1e6)

        if "transp" in variants:
            @functools.partial(jax.jit, static_argnames=("n_iter",))
            def chained_transp(keys, n_iter):
                def body(ks, _):
                    kt = ks[:, QLa].transpose(1, 3, 0, 2).reshape(
                        len(QL), D, N * A)
                    one = 1.0 + 1e-30 * kt[0, 0, 0]
                    return ks.at[0, 0, 0].multiply(one), None
                ks, _ = jax.lax.scan(body, keys, None, length=n_iter)
                return ks[0, 0, 0, 0]
            per_op("transpose-only[f32]", chained_transp, db_keys)

        if "distkt" in variants:
            @functools.partial(jax.jit, static_argnames=("n_iter",))
            def chained_distkt(qf, ks, n_iter):
                def body(c, _):
                    d2m = dist_from_kt(ks, c)
                    return c * (1.0 + 1e-30 * d2m.min()), None
                c, _ = jax.lax.scan(body, qf, None, length=n_iter)
                return c[0, 0, 0]
            per_op("dist-kt[f32 pre-transposed]", chained_distkt, qsel,
                   kt_dev)

        if "searchkt" in variants:
            from contour_context_tpu.db import _topk_min

            @functools.partial(jax.jit, static_argnames=("n_iter", "strategy"))
            def chained_searchkt(qf, ks, n_iter, strategy="cover"):
                def body(c, _):
                    d2m = dist_from_kt(ks, c)
                    dist, idx = _topk_min(d2m, args.nnk, strategy)
                    return c * (1.0 + 1e-30 * dist.min()), None
                c, _ = jax.lax.scan(body, qf, None, length=n_iter)
                return c[0, 0, 0]
            per_op("search-kt[f32 cover pre-transposed]", chained_searchkt,
                   qsel, kt_dev)

            def skt_block(qf, ks, n_iter):
                return chained_searchkt(qf, ks, n_iter, "block")
            per_op("search-kt[f32 block pre-transposed]", skt_block,
                   qsel, kt_dev)

    print("DONE", flush=True)


if __name__ == "__main__":
    main()
