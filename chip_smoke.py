#!/usr/bin/env python
"""Smoke test: the loop-closure path on the GPU, checked against references.

    python chip_smoke.py            # one GPU: parity, replay and map phases
    python chip_smoke.py --gpus 4   # four GPUs: the row-sharded map only

Runs the main path once through the entry points a user calls, at the
shipping PipelineConfig() widths (150x150 BEV, six levels, 131072-point
clouds, 4096-pixel ring pool), and compares every stage with the
repository's independent references:

- parity: the descriptor vs the numpy oracle (oracle.build_scan); the check
  cascade and GMM correlation vs the oracle's sequential checks; the key
  search and the exact min-k vs a numpy stable argsort over a store with
  planted duplicate keys; the fused query vs the host CandidateManager
  replica (db.query_ranged_knn_host).
- replay: the batch CLI (`contour_context_tpu.__main__.main`, called
  in-process) on an on-disk synthetic dataset in the KITTI two-file
  format: 300 scans with --fused-step against the committed CPU outcome
  (tests/golden/), and a 1000-scan, 14-lap saturation soak with --chain 16
  scored by eval.pr_mpe; then a ContourDB.save / ContourDB.load round trip.
- map: a 131072-scan frozen map tiled from the soak's rows, served with
  localize_block_async and searched against a numpy brute force over all of
  its keys.

Each phase prints one JSON line with its comparisons, wall seconds and
compile count. A failed comparison raises, so any failure exits non-zero.
The last stdout line is {"ok": true, "device": {...}}. Times printed here
are smoke timings, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from synth import (build_trajectory, make_world, render_scan,  # noqa: E402
                   write_synth_dataset)

from contour_context_tpu import oracle  # noqa: E402
from contour_context_tpu.config import PipelineConfig  # noqa: E402
from contour_context_tpu.db import MAX_DIST_SQ  # noqa: E402
from contour_context_tpu.utils.compile_cache import (  # noqa: E402
    cache_dir, enable_compile_cache)
from contour_context_tpu.utils.io import pad_points  # noqa: E402

GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
REPLAY_SCANS, SOAK_SCANS, MAP_SCANS = 300, 1000, 131072
REPLAY_FLAGS = {"replay": ["--fused-step"], "soak": ["--chain", "16"]}
REPLAY_LEN = {"replay": REPLAY_SCANS, "soak": SOAK_SCANS}
EXCL_FRAMES = 15        # the 15 s window at 1 Hz (scripts/synth_benchmark.py)
SOAK_F1_TOL = 0.005


def check(cond, msg):
    """Raise on a failed comparison (not `assert`: it must survive -O)."""
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# device, header, compile counting
# ---------------------------------------------------------------------------

def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, one line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().replace("\n", " | ")


def require_gpu(n: int = 1):
    """The smoke test runs only on GPUs: raise SystemExit otherwise."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {devs}")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke --gpus {n} found {len(devs)} GPUs")
    return devs


class CompileLog:
    """Counts backend compilations (and their seconds) through JAX's
    monitoring events; a phase reports the difference across its run."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, name, secs, **_):
        if name == self.EVENT:
            self.count += 1
            self.seconds += secs


def run_phase(name, fn, log: CompileLog, *args):
    c0, s0, t0 = log.count, log.seconds, time.perf_counter()
    checks = fn(*args)
    line = {"phase": name, "ok": True,
            "seconds": round(time.perf_counter() - t0, 1),
            "compiles": log.count - c0,
            "compile_seconds": round(log.seconds - s0, 1),
            "checks": checks}
    print(json.dumps(line, default=float), flush=True)


def bur_median_ms(fn, *args, reps: int = 20) -> float:
    """Median wall time of fn(*args) under block_until_ready, first call
    (compile) excluded."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------

def topk_min_reference(d2m: np.ndarray, k: int):
    """Min-k over the last axis, ascending, ties to the lower index: the
    order db._topk_min promises (a stable argsort)."""
    order = np.argsort(d2m, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(d2m, order, axis=-1), order


def key_distances_reference(keys_q: np.ndarray, q_keys: np.ndarray,
                            searchable_n: int, q_levels):
    """Masked squared key distances (Q, A, N*A) as db._key_distances
    computes them: float32, dimensions accumulated in order 0..D-1, each
    product rounded before its add.

    keys_q is the (L, D, N*A) search layout (db._keys_to_q_layout)."""
    lv = list(q_levels)
    kt = np.asarray(keys_q)[lv].astype(np.float32)          # (Q, D, NA)
    q = np.asarray(q_keys)[lv].astype(np.float32)           # (Q, A, D)
    Q, D, NA = kt.shape
    A = q.shape[1]
    d2 = np.zeros((Q, A, NA), np.float32)
    for d in range(D):
        diff = kt[:, d][:, None, :] - q[:, :, d][:, :, None]
        d2 = d2 + diff * diff
    row_valid = np.abs(kt).sum(1) > 0
    searchable = (np.arange(NA) // A) < searchable_n
    q_valid = np.abs(q).sum(-1) > 0
    ok = row_valid[:, None, :] & searchable[None, None, :] & q_valid[..., None]
    return np.where(ok, d2, np.float32(MAX_DIST_SQ)), q


def search_reference(keys_q, q_keys, searchable_n, q_levels, nnk):
    """(gidx, seq_src, dist, valid), each (Q, A, nnk): db._search_impl's
    contract — the nnk nearest keys per (level, anchor), ties to the lower
    index, valid below the adaptive distance bound."""
    d2, q = key_distances_reference(keys_q, q_keys, searchable_n, q_levels)
    A = q.shape[1]
    dist, idx = topk_min_reference(d2, min(nnk, d2.shape[-1]))
    k0, k1, k2 = q[..., 0], q[..., 1], q[..., 2]
    f = np.float32
    ub = (np.maximum((k0 - k0 * f(0.8)) ** 2, (k0 - k0 / f(0.8)) ** 2)
          + np.maximum((k1 - k1 * f(0.8)) ** 2, (k1 - k1 / f(0.8)) ** 2)
          + np.maximum((k2 - k2 * f(0.8 * 0.75)) ** 2,
                       (k2 - k2 / f(0.8 * 0.75)) ** 2))
    valid = dist < np.minimum(ub[..., None], f(MAX_DIST_SQ))
    return idx // A, idx % A, dist, valid


def hits_of(gidx, seq, valid):
    """Per (level, anchor) ranked list of valid (gidx, seq) hits."""
    g, s, v = (np.asarray(x) for x in (gidx, seq, valid))
    return [[(int(a), int(b)) for a, b, ok in zip(gr, sr, vr) if ok]
            for gr, sr, vr in zip(g.reshape(-1, g.shape[-1]),
                                  s.reshape(-1, s.shape[-1]),
                                  v.reshape(-1, v.shape[-1]))]


def match_search(device, keys_q, q_keys, searchable_n, q_levels, nnk):
    """Compare device search hits with the numpy reference: the ranked hit
    lists of every (level, anchor) must be identical."""
    got = hits_of(device[0], device[1], device[3])
    ref = search_reference(keys_q, q_keys, searchable_n, q_levels, nnk)
    want = hits_of(ref[0], ref[1], ref[3])
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    check(not bad, f"search hits differ from numpy at rows {bad}")
    return {"hits": sum(map(len, got))}


# ---------------------------------------------------------------------------
# phase 1: parity
# ---------------------------------------------------------------------------

def parity_descriptor(cfg: PipelineConfig, scans):
    from contour_context_tpu.ops.descriptor import (build_descriptor,
                                                    rasterize_bev)

    cm = cfg.cm
    raster = jax.jit(rasterize_bev, static_argnames=("cfg",))
    worst = dict(bev=0.0, keys=0.0)
    descs = []
    for i, pts in enumerate(scans):
        padded = pad_points(pts, cm.max_points)
        osc = oracle.build_scan(pts, cm, i)
        bev, rowf, _ = (np.asarray(a) for a in raster(padded, cm))
        ob = oracle.make_bev(pts, cm)
        bev = bev.reshape(cm.n_row, cm.n_col)
        np.testing.assert_allclose(bev, ob.bev, atol=1e-5)
        occ = ob.bev > -999
        np.testing.assert_allclose(rowf.reshape(cm.n_row, cm.n_col)[occ],
                                   ob.rowf[occ], atol=1e-4)
        worst["bev"] = max(worst["bev"], float(np.abs(bev - ob.bev).max()))

        desc = build_descriptor(jnp.asarray(padded), cm, cfg.gmm)
        descs.append(desc)
        d = jax.tree.map(np.asarray, desc)
        for ll in range(cm.n_levels):
            conts = osc.cont_views[ll]
            check(int(d.n_cont[ll]) == len(conts), (i, ll, "n_cont"))
            check(int(d.layer_cell_cnt[ll]) == osc.layer_cell_cnt[ll],
                  (i, ll, "layer_cell_cnt"))
            for k, c in enumerate(conts[: cm.max_contours]):
                check(int(d.cnt[ll, k]) == c.cell_cnt, (i, ll, k, "cnt"))
                np.testing.assert_allclose(d.mean[ll, k], c.pos_mean,
                                           atol=2e-3, rtol=1e-4)
                np.testing.assert_allclose(d.eig_vals[ll, k], c.eig_vals,
                                           atol=5e-3, rtol=1e-3)
                np.testing.assert_allclose(
                    abs(float(np.dot(d.eig_vecs[ll, k][:, 1],
                                     c.eig_vecs[:, 1]))), 1.0, atol=1e-3)
                np.testing.assert_allclose(d.vol3_mean[ll, k], c.vol3_mean,
                                           atol=2e-3, rtol=1e-4)
                check(bool(d.ecc_feat[ll, k]) == c.ecc_feat,
                      (i, ll, k, "ecc"))
        np.testing.assert_allclose(d.keys, osc.keys, atol=2e-2, rtol=2e-3)
        worst["keys"] = max(worst["keys"],
                            float(np.abs(d.keys - osc.keys).max()))
        for ll in range(cm.n_levels):
            for seq in range(cm.piv_firsts):
                ob_ = osc.bcis[ll][seq]
                nv = d.nei_valid[ll, seq]
                if ob_ is None:
                    check(not nv.any(), (i, ll, seq, "bci"))
                    continue
                n = int(nv.sum())
                check(n == len(ob_.nei_bit), (i, ll, seq, "bci count"))
                for name in ("nei_bit", "nei_level", "nei_seq"):
                    np.testing.assert_array_equal(getattr(d, name)[ll, seq][:n],
                                                  getattr(ob_, name))
                np.testing.assert_allclose(d.nei_theta[ll, seq][:n],
                                           ob_.nei_theta, atol=1e-4)
        model = oracle.build_gmm(osc, cfg.gmm)
        np.testing.assert_allclose(float(d.auto_corr), model.auto_corr,
                                   rtol=2e-3)
    return descs, {"scans": len(scans), "bev_max_abs_err": worst["bev"],
                   "keys_max_abs_err": worst["keys"]}


def _oracle_hint(osc_src, osc_tgt, level, ss, st, sim, lb):
    """The oracle's sequential check chain for one hint."""
    out = dict(pass1=False, pass2=False, pass3=False)
    if not (len(osc_src.cont_views[level]) > ss
            and len(osc_tgt.cont_views[level]) > st):
        return out
    if not oracle.check_sim(osc_src.cont_views[level][ss],
                            osc_tgt.cont_views[level][st], sim):
        return out
    out["pass1"] = True
    bs, bt = osc_src.bcis[level][ss], osc_tgt.bcis[level][st]
    if bs is None or bt is None:
        return out
    score2, pairs = oracle.check_constell_sim(bs, bt, lb.sim_constell)
    out["score2"] = score2
    if pairs is None:
        return out
    out["pass2"] = True
    _, pairs2, _ = oracle.check_constell_corresp_sim(
        osc_src, osc_tgt, pairs, lb.sim_pair, sim)
    if pairs2 is None:
        return out
    out["pass3"] = True
    out["pairs"] = set(pairs2)
    out["T"] = oracle.umeyama_se2(osc_src, osc_tgt, pairs2)
    return out


def gmm_init_pose(pose_b, n_row: int):
    """BEV-frame (x, y, theta) that maps scan A (at the origin) onto scan B
    at world pose `pose_b`: the inverse of getEstSensTF's conjugation."""
    xb, yb, thb = pose_b
    dth = -thb
    c, s = math.cos(dth), math.sin(dth)
    dx = c * -xb - s * -yb
    dy = s * -xb + c * -yb
    ox = n_row / 2 - 0.5
    return np.array([dx + ox - (c * ox - s * ox),
                     dy + ox - (s * ox + c * ox), dth])


CASCADE_PAIRS = [(3, (2.0, 1.0, 0.3), (10, 11)),
                 (5, (1.0, -2.0, -0.2), (20, 21)),
                 (8, (4.0, 3.0, 0.7), (30, 31)),
                 (13, (0.2, 0.1, 0.02), (40, 41))]


def parity_cascade(cfg: PipelineConfig, pairs=CASCADE_PAIRS):
    from contour_context_tpu.db import _gather_and_cascade
    from contour_context_tpu.ops.descriptor import build_descriptor
    from contour_context_tpu.ops.gmm import (gmm_from_desc, init_correlation,
                                             optimize_correlation)

    cm, sim, lb = cfg.cm, cfg.db.cont_sim, cfg.thres_lb
    gcfg = cfg.gmm
    out = []
    for wseed, pose_b, (sa, sb) in pairs:
        world = make_world(wseed)
        pts_a = render_scan(world, (0.0, 0.0, 0.0), seed=sa)
        pts_b = render_scan(world, pose_b, seed=sb)
        osc_a, osc_b = oracle.build_scan(pts_a, cm, 0), oracle.build_scan(
            pts_b, cm, 1)
        da = build_descriptor(pad_points(pts_a, cm.max_points), cm, gcfg)
        db_ = build_descriptor(pad_points(pts_b, cm.max_points), cm, gcfg)
        hints = [(lv, ss, st) for lv in (1, 2, 3)
                 for ss in range(cm.piv_firsts) for st in range(cm.piv_firsts)
                 if np.abs(osc_a.keys[lv][ss]).sum() > 0
                 and np.abs(osc_b.keys[lv][st]).sum() > 0]
        check(len(hints) > 4, (wseed, "too few hints"))
        H = len(hints)
        res = _gather_and_cascade(
            jax.tree.map(lambda x: x[None], da), db_, jnp.zeros(H, jnp.int32),
            jnp.asarray([h[0] for h in hints], jnp.int32),
            jnp.asarray([h[1] for h in hints], jnp.int32),
            jnp.asarray([h[2] for h in hints], jnp.int32),
            jnp.ones(H, bool), lb, sim)
        res = jax.tree.map(np.asarray, res)
        n3 = 0
        for i, (level, ss, st) in enumerate(hints):
            o = _oracle_hint(osc_a, osc_b, level, ss, st, sim, lb)
            for k in ("pass1", "pass2", "pass3"):
                check(bool(getattr(res, k)[i]) == o[k], (wseed, hints[i], k))
            if o["pass2"]:
                check((int(res.ovlp_sum[i]), int(res.ovlp_max_one[i]),
                       int(res.in_ang_rng[i])) == tuple(o["score2"]),
                      (wseed, hints[i], "score2"))
            if o["pass3"]:
                n3 += 1
                got = {(int(res.pair_level[i, j]), int(res.pair_seq_src[i, j]),
                        int(res.pair_seq_tgt[i, j]))
                       for j in np.flatnonzero(res.pair_valid[i])}
                check(got == o["pairs"], (wseed, hints[i], "pairs"))
                T_o = o["T"]
                np.testing.assert_allclose(res.T_delta[i, :2], T_o[:2, 2],
                                           atol=5e-2)
                np.testing.assert_allclose(
                    res.T_delta[i, 2], math.atan2(T_o[1, 0], T_o[0, 0]),
                    atol=1e-2)
        check(n3 >= 1, (wseed, "the revisit passed no hint"))

        # GMM: batched init correlation and LM refinement vs the oracle
        T_init = gmm_init_pose(pose_b, cm.n_row)
        c, s = math.cos(T_init[2]), math.sin(T_init[2])
        T33 = np.array([[c, -s, T_init[0]], [s, c, T_init[1]], [0, 0, 1.0]])
        ga, gb = oracle.build_gmm(osc_a, gcfg), oracle.build_gmm(osc_b, gcfg)
        corr_o = oracle.gmm_correlation(
            ga, gb, oracle.gmm_select_pairs(ga, gb, T33, gcfg), T_init, gcfg)
        batch = jax.tree.map(lambda x: jnp.asarray(x)[None],
                             gmm_from_desc(da, gcfg))
        jgb = gmm_from_desc(db_, gcfg)
        T0 = jnp.asarray(T_init, jnp.float32)[None]
        corr_j, sel_j = init_correlation(batch, jgb, T0)
        np.testing.assert_allclose(float(corr_j[0]), corr_o, rtol=2e-2)
        corr_f, _ = optimize_correlation(batch, jgb, T0, sel_j)
        check(float(corr_f[0]) >= float(corr_j[0]) - 1e-4,
              (wseed, "LM lowered the correlation"))
        out.append({"world": wseed, "hints": H, "pass3": n3,
                    "corr_oracle": corr_o, "corr_init": float(corr_j[0]),
                    "corr_refined": float(corr_f[0])})
    return out


def parity_search(descs, n_store: int = 8192, seed: int = 0):
    """_search (every top-k strategy) and _topk_min against a numpy stable
    argsort, on a store of keys perturbed from real scans with planted
    exact duplicates, so tie order is exercised."""
    from contour_context_tpu.db import _keys_to_q_layout, _search, _topk_min

    rng = np.random.default_rng(seed)
    proto = np.stack([np.asarray(d.keys) for d in descs])      # (8, L, A, D)
    pick = rng.integers(0, len(proto), n_store)
    keys = proto[pick] * (1.0 + 0.05 * rng.standard_normal(
        (n_store,) + proto.shape[1:])).astype(np.float32)
    keys = np.where(proto[pick] != 0, keys, 0.0).astype(np.float32)
    q = np.asarray(descs[0].keys)
    keys[100:164] = keys[7]                       # duplicate rows
    keys[300:310] = q                             # zero-distance ties
    keys[5000:5040] = keys[300]
    searchable = n_store - 100
    q_levels, nnk = (1, 2, 3), 50
    kq = np.asarray(_keys_to_q_layout(keys))
    out = {}
    for strategy in ("block", "cover", "cover2"):
        dev = _search(jnp.asarray(keys), jnp.asarray(q), jnp.int32(searchable),
                      q_levels, nnk, strategy)
        out[strategy] = match_search(dev, kq, q, searchable, q_levels, nnk)

    d2, _ = key_distances_reference(kq, q, searchable, q_levels)
    tied = (rng.integers(0, 512, d2.shape) / 7.0).astype(np.float32)
    for name, mat in (("masked_distances", d2), ("quantized", tied)):
        want_v, want_i = topk_min_reference(mat, nnk)
        for strategy in ("block", "cover"):
            v, i = _topk_min(jnp.asarray(mat), nnk, strategy)
            np.testing.assert_array_equal(np.asarray(i), want_i)
            np.testing.assert_array_equal(np.asarray(v), want_v)
        out[f"topk_{name}"] = "identical"
    return out


def parity_fused_query(cfg: PipelineConfig):
    """The fused query vs the host CandidateManager replica on a sequence
    with revisits (tests/test_fused_query.py's contract: caps raised so the
    fused path sees every hit the host path sees)."""
    import dataclasses

    from contour_context_tpu.db import ContourDB
    from contour_context_tpu.ops.descriptor import build_descriptor

    cfg = dataclasses.replace(cfg, db=dataclasses.replace(
        cfg.db, max_check_cands=1024, max_pass_hints=128))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.5, 0.8, 0.2), (30.0, -1.0, -0.15), (110.0, 40.0, 0.6)]
    db = ContourDB(cfg, capacity=len(poses) + 2)
    n_found = 0
    for i, pose in enumerate(poses):
        pts = render_scan(world, pose, seed=500 + i)
        desc = build_descriptor(pad_points(pts, cfg.cm.max_points), cfg.cm,
                                cfg.gmm)
        r_dev, r_host = db.query_ranged_knn(desc), db.query_ranged_knn_host(
            desc)
        if r_host is None:
            check(r_dev is None, (i, "fused found a loop the host did not"))
        else:
            check(r_dev is not None, (i, "fused missed the host's loop"))
            check(r_dev[0] == r_host[0], (i, r_dev[0], r_host[0]))
            np.testing.assert_allclose(r_dev[1], r_host[1], rtol=1e-3,
                                       atol=1e-4)
            np.testing.assert_allclose(r_dev[2], r_host[2], rtol=1e-3,
                                       atol=1e-3)
            n_found += 1
        db.add_scan(desc, i, 6.0 * i)
        db.push_and_balance(6.0 * i)
    check(n_found >= 2, f"only {n_found} loops found")
    for k in ("overflow_hints", "overflow_pass", "overflow_cand"):
        check(db.counters[k] == 0, (k, db.counters[k]))
    return {"queries": len(poses), "found": n_found,
            "n_hints": db.counters["n_hints"]}


def ring_key_timing(cfg: PipelineConfig, points: np.ndarray):
    """Smoke timing: the ring-key stage (descriptor.ring_histograms) alone
    at the shipping shape vs one whole descriptor build."""
    from contour_context_tpu.ops.descriptor import (
        build_descriptor, cc_labels, component_tables, pixel_pool,
        rasterize_bev, ring_histograms)

    cm = cfg.cm

    @jax.jit
    def ring_inputs(p):
        bev, rowf, colf = rasterize_bev(p, cm)
        grads = jnp.array(cm.lv_grads, jnp.float32)
        masks = bev.reshape(cm.n_row, cm.n_col)[None] > grads[:, None, None]
        tab = component_tables(cc_labels(masks, cm.cc_flush),
                               masks.reshape(cm.n_levels, -1), bev, rowf,
                               colf, cm)
        mean = tab["mean"][:, :cm.piv_firsts]
        pool, _ = pixel_pool(bev, rowf, colf, cm)
        return mean[..., 0].reshape(-1), mean[..., 1].reshape(-1), pool

    p = jnp.asarray(pad_points(points, cm.max_points))
    v0, v1, pool = ring_inputs(p)
    ring = jax.jit(ring_histograms, static_argnames=("cfg",))
    ring_ms = bur_median_ms(ring, v0, v1, pool, cm, reps=50)
    build_ms = bur_median_ms(build_descriptor, p, cm, cfg.gmm, reps=50)
    return {"anchors": int(v0.shape[0]), "pool": int(pool[0].shape[0]),
            "divisions": 35, "ring_ms": ring_ms, "build_ms": build_ms,
            "ring_share_of_build": ring_ms / build_ms,
            "label": "smoke timing, median of 50 under block_until_ready"}


def phase_parity(cfg: PipelineConfig):
    world = make_world(0, n_structs=260, extent=180.0)
    rng = np.random.default_rng(1)
    scans = [render_scan(world, p, seed=int(rng.integers(1 << 30)))
             for p in build_trajectory(8, rng)]
    descs, desc_checks = parity_descriptor(cfg, scans)
    return {"descriptor": desc_checks,
            "cascade_gmm": parity_cascade(cfg),
            "search": parity_search(descs),
            "fused_query": parity_fused_query(cfg),
            "ring_key": ring_key_timing(cfg, scans[0])}


# ---------------------------------------------------------------------------
# phase 2: replay through the batch CLI
# ---------------------------------------------------------------------------

def make_replay_dataset(out_dir: str, n_scans: int, seed: int = 0):
    """scripts/synth_benchmark.py's boxes world and loopy trajectory as an
    on-disk KITTI-format dataset, 1 s between scans. Returns
    (world, poses, f_pose, f_lid)."""
    world = make_world(seed, n_structs=260, extent=180.0)
    rng = np.random.default_rng(seed)
    poses = build_trajectory(n_scans, rng)
    f_pose, f_lid = write_synth_dataset(out_dir, world, poses, rng)
    return world, poses, f_pose, f_lid


def run_replay(kind: str, tmp: str):
    """One in-process CLI replay (`kind` "replay" or "soak"); returns
    (pipeline, f_pose, f_outcome, world, poses)."""
    from contour_context_tpu.__main__ import main as cli_main

    out = os.path.join(tmp, kind)
    os.makedirs(out, exist_ok=True)
    world, poses, f_pose, f_lid = make_replay_dataset(out, REPLAY_LEN[kind])
    f_out = os.path.join(out, "outcome.txt")
    pipe = cli_main(["--pose", f_pose, "--laser", f_lid, "--outcome", f_out]
                    + REPLAY_FLAGS[kind])
    return pipe, f_pose, f_out, world, poses


def outcome_fields(path: str):
    """(tfpn, pair, corr, err_x, err_y, err_theta) of each outcome line."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            rows.append((int(p[0]), p[1], float(p[2]), float(p[3]),
                         float(p[4]), float(p[5])))
    return rows


def golden_path(kind: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{kind}_outcome.txt")


def write_golden(kind: str) -> str:
    """Write the committed outcome of one replay `kind`. Run it on the CPU
    backend (JAX_PLATFORMS=cpu); the GPU smoke test compares against it."""
    with tempfile.TemporaryDirectory() as tmp:
        _, _, f_out, _, _ = run_replay(kind, tmp)
        rows = outcome_fields(f_out)
    path = golden_path(kind)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# chip_smoke.py {kind}: {REPLAY_LEN[kind]} scans, CLI flags "
                f"{' '.join(REPLAY_FLAGS[kind])}, backend "
                f"{jax.default_backend()}, jax {jax.__version__}\n"
                "# tfpn pair corr err_x err_y err_theta\n")
        for r in rows:
            f.write("%d\t%s\t%g\t%g\t%g\t%g\n" % r)
    return path


def score_rows(f_pose: str, rows, tmp: str, name: str):
    from contour_context_tpu.eval.pr_mpe import score_outcome

    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        for r in rows:
            f.write("%d\t%s\t%g\t%g\t%g\t%g\n" % r)
    res = score_outcome(f_pose, path, excl_frames=EXCL_FRAMES)
    tfpn = [r[0] for r in rows]
    return {"max_f1": res.max_f1, "tp_at_max_f1": res.tp_count,
            "recall_at_p1": res.recall_at_p1, "trans_mean_m": res.trans_mean,
            "rot_mean_deg": res.rot_mean_deg,
            "tp": tfpn.count(0), "fp": tfpn.count(1), "fn": tfpn.count(3)}


def decision_diffs(got, want):
    return [(w[1], g[0], g[1]) for g, w in zip(got, want)
            if (g[0], g[1]) != (w[0], w[1])]


class ChainTimer:
    """Times every ContourDB.step_chain_async call under block_until_ready
    while installed (smoke timing of the chained replay)."""

    def __init__(self):
        from contour_context_tpu.db import ContourDB

        self.cls, self.orig, self.secs = ContourDB, ContourDB.step_chain_async, []

    def __enter__(self):
        orig, secs = self.orig, self.secs

        def timed(db, points_k, seqs, ts_k):
            t0 = time.perf_counter()
            h = orig(db, points_k, seqs, ts_k)
            jax.block_until_ready(h.recs)
            secs.append((time.perf_counter() - t0, len(seqs)))
            return h

        self.cls.step_chain_async = timed
        return self

    def __exit__(self, *exc):
        self.cls.step_chain_async = self.orig


def phase_replay(cfg: PipelineConfig, tmp: str, state: dict):
    from contour_context_tpu.db import ContourDB
    from contour_context_tpu.ops.descriptor import build_descriptor

    # (a) 300 scans, one fused dispatch per scan: identical to the CPU run
    _, f_pose, f_out, _, _ = run_replay("replay", tmp)
    got, want = outcome_fields(f_out), outcome_fields(golden_path("replay"))
    check(len(got) == len(want), (len(got), len(want)))
    diffs = decision_diffs(got, want)
    corr_diffs = sorted(((abs(g[2] - w[2]), w[1], g[2], w[2])
                         for g, w in zip(got, want) if g[2] != w[2]),
                        reverse=True)
    corr_err = corr_diffs[0][0] if corr_diffs else 0.0
    check(not diffs, f"replay decisions differ from the CPU outcome: {diffs}")
    check(corr_err <= 1e-3, "replay correlation differs (|diff|, pair, "
          f"gpu, cpu): {corr_diffs[:10]}")
    replay = {"scans": len(got), "decision_diffs": 0,
              "corr_max_abs_diff": corr_err,
              "corr_diffs_over_1e-5": sum(d[0] > 1e-5 for d in corr_diffs),
              "score": score_rows(f_pose, got, tmp, "replay_scored.txt")}

    # (b) 1000-scan saturation soak, 16 scans per dispatch
    with ChainTimer() as timer:
        pipe, f_pose, f_out, world, poses = run_replay("soak", tmp)
    got, want = outcome_fields(f_out), outcome_fields(golden_path("soak"))
    check(len(got) == len(want), (len(got), len(want)))
    s_gpu = score_rows(f_pose, got, tmp, "soak_scored.txt")
    s_cpu = score_rows(f_pose, want, tmp, "soak_cpu_scored.txt")
    check(abs(s_gpu["max_f1"] - s_cpu["max_f1"]) <= SOAK_F1_TOL,
          f"soak max-F1 {s_gpu['max_f1']} vs CPU {s_cpu['max_f1']}")
    chains = [t / k for t, k in timer.secs[1:]]     # first call compiles
    soak = {"scans": len(got), "score": s_gpu, "cpu_score": s_cpu,
            "decision_diffs": decision_diffs(got, want),
            "overflow": {k: v for k, v in pipe.db.counters.items()
                         if k.startswith("overflow")},
            "per_scan_ms": {
                "median": float(np.median(chains) * 1e3),
                "chains": len(chains), "card": card_line(),
                "label": "smoke timing: step_chain_async(16) wall time "
                         "under block_until_ready per scan, not a "
                         "benchmark number"}}

    # save / load round trip: the reloaded map answers a query identically
    db = pipe.db
    path = os.path.join(tmp, "soak_map.npz")
    db.save(path)
    db2 = ContourDB.load(path, cfg)
    x, y, th = poses[len(poses) // 2]
    q = build_descriptor(jnp.asarray(pad_points(
        render_scan(world, (x + 0.4, y - 0.3, th + 0.05), seed=7),
        cfg.cm.max_points)), cfg.cm, cfg.gmm)
    r1 = np.asarray(jax.device_get(db.query_async(q).rec))
    r2 = np.asarray(jax.device_get(db2.query_async(q).rec))
    np.testing.assert_array_equal(r1, r2)
    state.update(db=db, world=world, poses=poses)
    return {"replay": replay, "soak": soak,
            "save_load": {"rows": db2.n, "found": bool(r1[0] > 0.5),
                          "record_identical": True}}


# ---------------------------------------------------------------------------
# phase 3: the city-scale frozen map
# ---------------------------------------------------------------------------

def tile_map(db, n_map: int, decoys: bool):
    """A frozen ContourDB of n_map rows tiled from db's rows, all searchable
    (__graft_entry__.tiled_store; `decoys` makes it answer exactly as db's
    own rows do)."""
    import functools

    from __graft_entry__ import tiled_store
    from contour_context_tpu.db import ContourDB, _keys_to_q_layout, _kq_dtype

    big = ContourDB(db.cfg, capacity=n_map)
    big.store = tiled_store(db.store, db.n, n_map, decoys)
    big.keys_q = jax.jit(functools.partial(
        _keys_to_q_layout, dtype=_kq_dtype(db.cfg)))(big.store.keys)
    big.ts_store = jnp.arange(n_map, dtype=jnp.float32)
    big.state = jnp.asarray([n_map, n_map], jnp.int32)
    big.n = n_map
    big.seq_of_gidx = [db.seq_of_gidx[g % db.n] for g in range(n_map)]
    return big


def phase_map(cfg: PipelineConfig, state: dict, n_map: int = MAP_SCANS,
              n_clouds: int = 16):
    from contour_context_tpu.db import ContourDB, _search_impl
    from contour_context_tpu.ops.descriptor import build_descriptor

    db, world, poses = state["db"], state["world"], state["poses"]
    n = db.n
    rng = np.random.default_rng(3)
    picks = np.linspace(100, len(poses) - 1, n_clouds).astype(int)
    clouds = np.stack([pad_points(render_scan(
        world, (poses[i][0] + rng.uniform(-0.5, 0.5),
                poses[i][1] + rng.uniform(-0.5, 0.5),
                poses[i][2] + rng.uniform(-0.05, 0.05)),
        seed=900 + k), cfg.cm.max_points) for k, i in enumerate(picks)])

    # plain tiles (every row ~n_map/n times): the search over all n_map
    # rows vs a numpy brute force, with exact ties everywhere
    big = tile_map(db, n_map, decoys=False)
    q = build_descriptor(jnp.asarray(clouds[0]), cfg.cm, cfg.gmm)
    search = jax.jit(_search_impl,
                     static_argnames=("q_levels", "nnk", "strategy"))
    args = (big.keys_q, q.keys, big.state[1], tuple(cfg.db.q_levels),
            cfg.db.nnk, cfg.db.topk_strategy)
    brute = match_search(search(*args), np.asarray(big.keys_q),
                         np.asarray(q.keys), n_map, cfg.db.q_levels,
                         cfg.db.nnk)
    search_ms = bur_median_ms(search, *args, reps=50)
    n_keys = int(np.prod(big.store.keys.shape[:3]))
    store_bytes = (sum(a.nbytes for a in jax.tree.leaves(big.store))
                   + big.keys_q.nbytes + big.ts_store.nbytes)
    del big, args

    # decoy tiles: the same n_map-row map answers exactly as the untiled
    # rows do, so every localized loop must match the untiled store's
    big = tile_map(db, n_map, decoys=True)
    small = ContourDB.merge([db])        # the untiled rows, all searchable
    got = big.localize_block_async(clouds, chunk=16).get()
    ref = small.localize_block_async(clouds, chunk=16).get()
    for k, (g, r) in enumerate(zip(got, ref)):
        check((g is None) == (r is None), (k, "found differs", g, r))
        if g is not None:
            check(g[0] % n == r[0], (k, "gidx", g[0], r[0]))
            np.testing.assert_allclose(g[1], r[1], rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(g[2], r[2], rtol=1e-3, atol=1e-3)
    n_found = sum(g is not None for g in got)
    check(n_found > 0, "the map found no loop")
    stats = jax.devices()[0].memory_stats() or {}
    return {"map_scans": n_map, "tile_rows": n, "keys": n_keys,
            "localize": {"clouds": n_clouds, "found": n_found,
                         "gidx_agree_with_untiled": True},
            "brute_force_search": brute,
            "search_ms": search_ms,
            "search_label": "smoke timing: db._search_impl (bf16 keys_q, "
                            f"{cfg.db.topk_strategy}), median of 50 under "
                            "block_until_ready",
            "bytes_per_scan": store_bytes / n_map,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "serving_counters": big.serving_counters}


# ---------------------------------------------------------------------------
# four cards: the row-sharded map
# ---------------------------------------------------------------------------

def phase_sharded(cfg: PipelineConfig, n_gpus: int):
    from __graft_entry__ import dryrun_multichip

    return dryrun_multichip(n_gpus, cfg=cfg, n_map=MAP_SCANS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the row-sharded map on four GPUs")
    args = ap.parse_args(argv)
    print(json.dumps({
        "nvidia_smi": card_line(), "devices": str(jax.devices()),
        "jax": jax.__version__, "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "cache_dir": cache_dir()}), flush=True)
    devs = require_gpu(args.gpus)
    enable_compile_cache()
    log = CompileLog()
    cfg = PipelineConfig()
    if args.gpus > 1:
        run_phase("sharded_map", phase_sharded, log, cfg, args.gpus)
    else:
        state = {}
        with tempfile.TemporaryDirectory() as tmp:
            run_phase("parity", phase_parity, log, cfg)
            run_phase("replay", phase_replay, log, cfg, tmp, state)
        run_phase("map", phase_map, log, cfg, state)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
