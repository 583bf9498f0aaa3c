"""A/B of cc_labels loop strategies (the choice must be measured, not
reasoned: a static unroll has regressed the cc stage before).

Variants (all produce identical labels — the fixpoint is iteration-count
independent; asserted here before timing):
  r2loop    while_loop from labels0, 2 propagates / iteration
  pack2     r2loop control flow + packed fwd/rev stacked scans
  unroll3   3 static propagates + 1-propagate while tail
  unroll4   4 static propagates + 1-propagate while tail
  u2loop2   2 static propagates + 2-propagate while tail
  hilli4    unroll4 control flow + Hillis-Steele doubling shift+max for the
            segmented run flush (8 pad/slice/max steps per direction vs
            associative_scan's odd-even recursion, ~4x fewer XLA ops —
            aimed at the vmapped-16 chain form)
  hillsep4  hilli4 + separable 3x3 window min (shift+min ops instead of
            lax.reduce_window)

--vmap N batches the timed body over N scans (chains may build
descriptors in vmapped 16-scan chunks; per-scan ms = slope / N).

Run on the GPU:
    timeout 900 python scripts/cc_variants_bench.py > cc_var.log 2>&1
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
    ap.add_argument("--parity-only", action="store_true")
    ap.add_argument("--variants", default="r2loop,uroll3,uroll4",
                    help="comma list from: r2loop pack2 unroll3 unroll4 "
                         "u2loop2 uroll3 uroll4 hilli4 hillsep4 (docstring "
                         "names)")
    ap.add_argument("--vmap", type=int, default=1,
                    help="batch the timed body over N vmapped scans")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax
    from contour_context_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    from synth import make_world, render_scan

    from contour_context_tpu.config import ContourManagerConfig
    from contour_context_tpu.ops.descriptor import rasterize_bev
    from contour_context_tpu.utils.io import pad_points

    cm = ContourManagerConfig()
    world = make_world(1, n_structs=300, extent=400.0)
    pts_np = pad_points(render_scan(world, (40.0, 2.0, 0.3), seed=7),
                        cm.max_points)
    pts0 = jax.device_put(jnp.asarray(pts_np))
    K = args.chain

    def cc(masks, variant: str):
        L, nr, nc = masks.shape
        S = nr * nc
        lin = jnp.arange(S, dtype=jnp.int32).reshape(nr, nc)
        labels0 = jnp.where(masks, lin[None], S)
        brk = ~masks
        MAXV = (1 << 15) - 1
        packed_scans = variant in ("pack2", "unroll3", "unroll4", "u2loop2")
        hillis = variant in ("hilli4", "hillsep4")

        segs = {}
        for axis in (1, 2):
            b32 = brk.astype(jnp.int32)
            seg_f = jnp.cumsum(b32, axis=axis) << 15
            seg_r = jnp.flip(jnp.cumsum(jnp.flip(b32, axis=axis), axis=axis),
                             axis=axis) << 15
            if packed_scans:
                segs[axis] = jnp.stack([seg_f, jnp.flip(seg_r, axis=axis)])
            else:
                segs[axis] = (seg_f, seg_r)

        def shift_fwd(x, d, axis):
            # prepend d zeros, drop the tail: zeros never win a packed max
            # (every packed value has neg = MAXV - lab >= MAXV - S > 0)
            pad = [(0, 0)] * x.ndim
            pad[axis] = (d, 0)
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(0, x.shape[axis])
            return jnp.pad(x, pad)[tuple(sl)]

        def shift_rev(x, d, axis):
            pad = [(0, 0)] * x.ndim
            pad[axis] = (0, d)
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(d, d + x.shape[axis])
            return jnp.pad(x, pad)[tuple(sl)]

        def run_min(lab, axis):
            neg = MAXV - lab
            if hillis:
                seg_f, seg_r = segs[axis]
                x = seg_f | neg
                y = seg_r | neg
                d = 1
                while d < lab.shape[axis]:
                    x = jnp.maximum(x, shift_fwd(x, d, axis))
                    y = jnp.maximum(y, shift_rev(y, d, axis))
                    d *= 2
                return MAXV - jnp.maximum(x & MAXV, y & MAXV)
            if packed_scans:
                packed = segs[axis] | jnp.stack(
                    [neg, jnp.flip(neg, axis=axis)])
                rm = lax.associative_scan(jnp.maximum, packed, axis=axis + 1)
                m = jnp.maximum(rm[0], jnp.flip(rm[1], axis=axis)) & MAXV
                return MAXV - m
            seg_f, seg_r = segs[axis]
            rm_f = lax.associative_scan(jnp.maximum, seg_f | neg, axis=axis)
            rm_r = lax.associative_scan(jnp.maximum, seg_r | neg, axis=axis,
                                        reverse=True)
            return MAXV - (jnp.maximum(rm_f & MAXV, rm_r & MAXV))

        def shiftv(x, d, axis):
            # value shift for the window min: out-of-bounds = S (neutral)
            if d > 0:
                return shift_fwd(x - S, d, axis) + S
            return shift_rev(x - S, -d, axis) + S

        def propagate(lab):
            if variant == "hillsep4":
                m = jnp.minimum(lab, jnp.minimum(shiftv(lab, 1, 1),
                                                 shiftv(lab, -1, 1)))
                neigh = jnp.minimum(m, jnp.minimum(shiftv(m, 1, 2),
                                                   shiftv(m, -1, 2)))
            else:
                neigh = lax.reduce_window(
                    lab, jnp.int32(S), lax.min,
                    window_dimensions=(1, 3, 3), window_strides=(1, 1, 1),
                    padding="SAME")
            new = jnp.where(masks, jnp.minimum(lab, neigh), S)
            new = jnp.where(masks, run_min(new, 2), S)
            return jnp.where(masks, run_min(new, 1), S)

        if variant in ("uroll3", "uroll4", "hilli4", "hillsep4"):
            # UNPACKED/doubling scans + static unroll
            n = 3 if variant == "uroll3" else 4
            ps = [labels0]
            for _ in range(n):
                ps.append(propagate(ps[-1]))

            def body(state):
                lab, _ = state
                new = propagate(lab)
                return new, jnp.any(new != lab)

            labels, _ = lax.while_loop(
                lambda s: s[1], body, (ps[-1], jnp.any(ps[-1] != ps[-2])))
        elif variant in ("r2loop", "pack2"):
            def body(state):
                lab, _ = state
                new = propagate(propagate(lab))
                return new, jnp.any(new != lab)

            labels, _ = lax.while_loop(lambda s: s[1], body,
                                       (labels0, jnp.bool_(True)))
        elif variant in ("unroll3", "unroll4"):
            n = 3 if variant == "unroll3" else 4
            ps = [labels0]
            for _ in range(n):
                ps.append(propagate(ps[-1]))

            def body(state):
                lab, _ = state
                new = propagate(lab)
                return new, jnp.any(new != lab)

            labels, _ = lax.while_loop(
                lambda s: s[1], body, (ps[-1], jnp.any(ps[-1] != ps[-2])))
        elif variant == "u2loop2":
            p1 = propagate(labels0)
            p2 = propagate(p1)

            def body(state):
                lab, _ = state
                new = propagate(propagate(lab))
                return new, jnp.any(new != lab)

            labels, _ = lax.while_loop(lambda s: s[1], body,
                                       (p2, jnp.any(p2 != p1)))
        else:
            raise ValueError(variant)
        return labels.reshape(L, S)

    nr, nc = cm.n_row, cm.n_col
    grads = jnp.array(cm.lv_grads, jnp.float32)

    V = max(1, args.vmap)
    if V > 1:
        pts_v = np.stack([
            pad_points(render_scan(world, (40.0 + 4.0 * i, 2.0, 0.3),
                                   seed=7 + i), cm.max_points)
            for i in range(V)])
        pts0 = jax.device_put(jnp.asarray(pts_v))

    def one_cc(p, variant):
        bev, _rf, _cf = rasterize_bev(p, cm)
        masks = (bev.reshape(nr, nc)[None] > grads[:, None, None])
        return cc(masks, variant)

    @functools.partial(jax.jit, static_argnames=("variant", "n_iter"))
    def chained(points, n_iter, variant):
        def body(p, _):
            if V > 1:
                lab = jax.vmap(lambda q: one_cc(q, variant))(p)
            else:
                lab = one_cc(p, variant)
            s = lab.sum().astype(jnp.float32)
            return p * (1.0 + 1e-30 * s).astype(p.dtype), s
        p, ss = jax.lax.scan(body, points, None, length=n_iter)
        return ss[-1]

    @functools.partial(jax.jit, static_argnames=("variant",))
    def full_labels(points, variant):
        p0 = points[0] if V > 1 else points
        return one_cc(p0, variant)

    t0 = time.time()
    _ = jax.device_get(jnp.zeros(4) + 1)
    print(f"mode switch paid ({time.time() - t0:.0f} s)", flush=True)

    variants = tuple(args.variants.split(","))
    # parity first (cheap: single dispatch each). Full element-wise label
    # compare — an int32 label SUM can wrap (L*S labels up to S ~ 3.0e9 >
    # int32 max) and two different labelings could collide.
    ref = None
    for v in variants:
        lab = np.asarray(jax.device_get(full_labels(pts0, v)))
        if ref is None:
            ref = lab
        else:
            assert np.array_equal(lab, ref), \
                (v, int((lab != ref).sum()), "label mismatch vs", variants[0])
    print("label parity OK (element-wise)", flush=True)
    if args.parity_only:
        print("DONE", flush=True)
        return

    def timed(v, n):
        r = chained(pts0, n, v)
        jax.device_get(r)
        ts_ = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = chained(pts0, n, v)
            jax.device_get(r)
            ts_.append(time.perf_counter() - t0)
        return min(ts_)

    for v in variants:
        t1 = timed(v, 1)
        tK = timed(v, K)
        ms = (tK - t1) / (K - 1) * 1e3
        print(f"cc[{v}]: {ms / V:.3f} ms/scan (vmap {V}; iter {ms:.3f} ms, "
              f"t1={t1*1e3:.1f}, tK={tK*1e3:.1f})", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
