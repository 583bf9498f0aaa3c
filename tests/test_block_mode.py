"""Batched throughput mode vs the sequential per-scan path: exact parity.

The temporal exclusion window (>=15 s) makes intra-block queries independent
of each other; _process_block replays the per-scan window updates, so results
must match the sequential query/add/push loop record-for-record.
"""

import os

import numpy as np
import pytest

from synth import make_world, render_scan, se3_from_xyt

from contour_context_tpu.config import ContourManagerConfig, PipelineConfig
from contour_context_tpu.db import ContourDB
from contour_context_tpu.ops.descriptor import build_descriptor
from contour_context_tpu.utils.io import pad_points


@pytest.mark.slow
def test_run_blocked_matches_run(tmp_path):
    """File-based replay: run_blocked(B) == run() outcome-for-outcome,
    including a tail block shorter than B, driven via the CLI module."""
    import subprocess
    import sys

    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.0 * (7 - i) + 0.5, 0.8, 0.15) for i in range(6)]  # 14 scans
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(tmp_path / ("%06d.bin" % i))
        arr.tofile(bp)
        T = se3_from_xyt(p)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    f_pose = str(tmp_path / "pose.txt")
    f_laser = str(tmp_path / "laser.txt")
    open(f_pose, "w").write("\n".join(pl))
    open(f_laser, "w").write("\n".join(ll))

    from contour_context_tpu.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu.pipeline import LoopClosurePipeline

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))

    ev1 = ContLCDEvaluator(f_pose, f_laser, cfg.correlation_thres)
    p1 = LoopClosurePipeline(cfg, ev1, capacity=32)
    p1.run()
    p1.save_outcome(str(tmp_path / "o_seq.txt"))

    ev2 = ContLCDEvaluator(f_pose, f_laser, cfg.correlation_thres)
    p2 = LoopClosurePipeline(cfg, ev2, capacity=32)
    p2.run_blocked(block=4)   # 14 scans = 3 blocks + 2-scan tail
    p2.save_outcome(str(tmp_path / "o_blk.txt"))

    seq_lines = open(str(tmp_path / "o_seq.txt")).readlines()
    blk_lines = open(str(tmp_path / "o_blk.txt")).readlines()
    assert len(seq_lines) == len(blk_lines) == 14
    for a, b in zip(seq_lines, blk_lines):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[0] == fb[0] and fa[1] == fb[1], (a, b)
        np.testing.assert_allclose(float(fa[2]), float(fb[2]),
                                   rtol=1e-3, atol=1e-4)
    assert any(ln.startswith("0\t") for ln in seq_lines)   # found loops

    # the CLI module drives the same replay
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');"
         "from contour_context_tpu.__main__ import main;"
         f"main(['--pose', {f_pose!r}, '--laser', {f_laser!r},"
         f" '--outcome', {str(tmp_path / 'o_cli.txt')!r}])"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 14 scans" in r.stdout, r.stdout[-500:]


@pytest.mark.slow
def test_run_chained_matches_run(tmp_path):
    """File-based replay: run_chained(K) == run() outcome-for-outcome,
    including a tail shorter than K."""
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.0 * (7 - i) + 0.5, 0.8, 0.15) for i in range(6)]  # 14 scans
    pl, ll = [], []
    for i, p in enumerate(poses):
        pts = render_scan(world, p, seed=500 + i)
        arr = np.zeros((len(pts), 4), np.float32)
        arr[:, :3] = pts
        bp = str(tmp_path / ("%06d.bin" % i))
        arr.tofile(bp)
        T = se3_from_xyt(p)
        pl.append("%.6f %s" % (6.0 * i, " ".join(
            "%.6f" % v for v in T[:3, :4].reshape(-1))))
        ll.append("%.6f %d %s" % (6.0 * i, i, bp))
    f_pose = str(tmp_path / "pose.txt")
    f_laser = str(tmp_path / "laser.txt")
    open(f_pose, "w").write("\n".join(pl))
    open(f_laser, "w").write("\n".join(ll))

    from contour_context_tpu.eval.evaluator import ContLCDEvaluator
    from contour_context_tpu.pipeline import LoopClosurePipeline

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))

    ev1 = ContLCDEvaluator(f_pose, f_laser, cfg.correlation_thres)
    p1 = LoopClosurePipeline(cfg, ev1, capacity=32)
    p1.run()
    p1.save_outcome(str(tmp_path / "o_seq.txt"))

    ev2 = ContLCDEvaluator(f_pose, f_laser, cfg.correlation_thres)
    p2 = LoopClosurePipeline(cfg, ev2, capacity=32)
    p2.run_chained(chain=4)   # 14 scans = 3 chains + 2-scan tail
    p2.save_outcome(str(tmp_path / "o_chn.txt"))

    seq_lines = open(str(tmp_path / "o_seq.txt")).readlines()
    chn_lines = open(str(tmp_path / "o_chn.txt")).readlines()
    assert len(seq_lines) == len(chn_lines) == 14
    for a, b in zip(seq_lines, chn_lines):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[0] == fb[0] and fa[1] == fb[1], (a, b)
        np.testing.assert_allclose(float(fa[2]), float(fb[2]),
                                   rtol=1e-3, atol=1e-4)
    assert any(ln.startswith("0\t") for ln in seq_lines)   # found loops


@pytest.mark.slow
def test_block_matches_sequential():
    import jax
    import jax.numpy as jnp

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    # out-and-back so later blocks contain genuine loop closures
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.0 * (7 - i) + 0.5, 0.8, 0.15) for i in range(8)]
    ts = [6.0 * i for i in range(len(poses))]

    descs = []
    for i, pose in enumerate(poses):
        pts = render_scan(world, pose, seed=500 + i)
        descs.append(build_descriptor(pad_points(pts, cfg.cm.max_points),
                                      cfg.cm, cfg.gmm))

    # sequential reference run
    db_seq = ContourDB(cfg, capacity=32)
    seq_results = []
    for i, d in enumerate(descs):
        h = db_seq.query_async(d)
        seq_results.append(h.get() if h is not None else None)
        db_seq.add_scan(d, i, ts[i])
        db_seq.push_and_balance(ts[i])

    # block mode, B=4
    db_blk = ContourDB(cfg, capacity=32)
    blk_results = []
    B = 4
    for b0 in range(0, len(descs), B):
        block = jax.tree.map(lambda *xs: jnp.stack(xs), *descs[b0:b0 + B])
        h = db_blk.process_block_async(
            block, list(range(b0, b0 + B)),
            np.asarray(ts[b0:b0 + B], np.float32))
        blk_results.extend(h.get())

    assert len(seq_results) == len(blk_results)
    n_found = 0
    for i, (rs, rb) in enumerate(zip(seq_results, blk_results)):
        if rs is None:
            assert rb is None, (i, rb)
            continue
        assert rb is not None, (i, rs)
        n_found += 1
        assert rs[0] == rb[0], (i, rs, rb)
        np.testing.assert_allclose(rb[1], rs[1], rtol=1e-4)
        np.testing.assert_allclose(rb[2], rs[2], rtol=1e-4, atol=1e-5)
    assert n_found >= 2, seq_results
    assert db_blk.n == db_seq.n
    assert db_blk.searchable_n == db_seq.searchable_n


@pytest.mark.slow
def test_block_chain_matches_process_block():
    """NB chained block steps in one dispatch == NB process_block_async
    dispatches (records + ring + window state)."""
    import jax
    import jax.numpy as jnp

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.0 * (7 - i) + 0.5, 0.8, 0.15) for i in range(8)]
    ts = np.asarray([6.0 * i for i in range(len(poses))], np.float32)
    descs = []
    for i, pose in enumerate(poses):
        pts = render_scan(world, pose, seed=500 + i)
        descs.append(build_descriptor(pad_points(pts, cfg.cm.max_points),
                                      cfg.cm, cfg.gmm))
    B = 4
    blocks = [jax.tree.map(lambda *xs: jnp.stack(xs), *descs[b:b + B])
              for b in range(0, len(descs), B)]

    db_a = ContourDB(cfg, capacity=32)
    recs_a = []
    for k, blk in enumerate(blocks):
        h = db_a.process_block_async(blk, list(range(k * B, (k + 1) * B)),
                                     ts[k * B:(k + 1) * B])
        recs_a.extend(h.get())

    db_b = ContourDB(cfg, capacity=32)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *blocks)
    h = db_b.block_chain_async(stacked, list(range(len(descs))),
                               ts.reshape(len(blocks), B))
    recs_b = h.get()

    assert len(recs_a) == len(recs_b)
    for i, (ra, rb) in enumerate(zip(recs_a, recs_b)):
        if ra is None:
            assert rb is None, i
            continue
        assert rb is not None and ra[0] == rb[0], i
        np.testing.assert_allclose(rb[1], ra[1], rtol=1e-4)
    assert db_b.n == db_a.n and db_b.searchable_n == db_a.searchable_n
    np.testing.assert_allclose(np.asarray(db_b.recs_store[:db_b.n]),
                               np.asarray(db_a.recs_store[:db_a.n]),
                               rtol=1e-4, atol=1e-5)


def test_block_chain_pts_matches_block_chain():
    """The FULL block chain (descriptor build in-dispatch,
    block_chain_pts_async) == the prebuilt-descriptor chain
    (block_chain_async) fed the same clouds: identical ring + state. The
    build depends only on the points, so hoisting it in/out of the dispatch
    cannot change records — this pins the r4 bench's full-pipeline block row
    to the tested prebuilt path."""
    import jax
    import jax.numpy as jnp

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.0 * (7 - i) + 0.5, 0.8, 0.15) for i in range(8)]
    ts = np.asarray([6.0 * i for i in range(len(poses))], np.float32)
    clouds = np.stack([
        pad_points(render_scan(world, pose, seed=500 + i), cfg.cm.max_points)
        for i, pose in enumerate(poses)])
    B = 4
    NB = len(poses) // B

    db_a = ContourDB(cfg, capacity=32)
    descs = [build_descriptor(jnp.asarray(c), cfg.cm, cfg.gmm)
             for c in clouds]
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs).reshape((NB, B) + xs[0].shape), *descs)
    ha = db_a.block_chain_async(stacked, list(range(len(poses))),
                                ts.reshape(NB, B))
    jax.block_until_ready(ha.recs)

    db_b = ContourDB(cfg, capacity=32)
    hb = db_b.block_chain_pts_async(
        jnp.asarray(clouds).reshape(NB, B, *clouds.shape[1:]),
        list(range(len(poses))), ts.reshape(NB, B))
    jax.block_until_ready(hb.recs)

    # An accelerator backend may fuse the in-dispatch vmapped build
    # differently from the one-by-one builds feeding the prebuilt chain
    # (reductions reassociated across the batch), so the GMM-refined corr/T
    # can drift a few 1e-4 — same class as the dyn-vs-scan accommodation
    # below; CPU keeps the tight pin.
    import jax
    tol = (dict(rtol=1e-5, atol=1e-6) if jax.default_backend() == "cpu"
           else dict(rtol=1e-3, atol=1e-3))
    np.testing.assert_allclose(np.asarray(hb.recs), np.asarray(ha.recs),
                               **tol)
    assert db_b.n == db_a.n and db_b.searchable_n == db_a.searchable_n


@pytest.mark.slow
def test_step_chain_matches_step_async():
    """ONE-dispatch K-step chain (lax.scan over the fused step) must equal
    K sequential step_async dispatches record-for-record — including with
    IRREGULAR sub-window timestamp gaps, where process_block_async's
    batched-query independence theorem does not apply."""
    import jax.numpy as jnp

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(11, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(8)]
    poses += [(10.0 * (7 - i) + 0.5, 0.8, 0.15) for i in range(8)]
    # irregular gaps: bursts of 1-2 s mixed with >15 s jumps, so the
    # searchable window genuinely shifts mid-chain
    gaps = [1.0, 2.0, 16.0, 1.0, 30.0, 1.5, 1.0, 20.0,
            2.0, 16.0, 1.0, 1.0, 25.0, 2.0, 1.0, 18.0]
    ts = np.cumsum(gaps).astype(np.float32)

    clouds = np.stack([
        pad_points(render_scan(world, p, seed=500 + i), cfg.cm.max_points)
        for i, p in enumerate(poses)])

    db_seq = ContourDB(cfg, capacity=32)
    seq_recs = []
    for i in range(len(poses)):
        h = db_seq.step_async(jnp.asarray(clouds[i]), i, float(ts[i]))
        seq_recs.append(h.get())

    db_ch = ContourDB(cfg, capacity=32)
    h1 = db_ch.step_chain_async(jnp.asarray(clouds[:7]), list(range(7)),
                                ts[:7])
    h2 = db_ch.step_chain_async(jnp.asarray(clouds[7:]),
                                list(range(7, len(poses))), ts[7:])
    chain_recs = h1.get() + h2.get()

    assert len(seq_recs) == len(chain_recs)
    n_found = 0
    for i, (rs, rc) in enumerate(zip(seq_recs, chain_recs)):
        if rs is None:
            assert rc is None, (i, rc)
            continue
        assert rc is not None, (i, rs)
        n_found += 1
        assert rs[0] == rc[0], (i, rs, rc)
        np.testing.assert_allclose(rc[1], rs[1], rtol=1e-4)
        np.testing.assert_allclose(rc[2], rs[2], rtol=1e-4, atol=1e-5)
    assert n_found >= 2, seq_recs
    assert db_ch.n == db_seq.n
    assert db_ch.searchable_n == db_seq.searchable_n
    # the chain wrote the same rows into the device record ring
    np.testing.assert_allclose(np.asarray(db_ch.recs_store[:db_ch.n]),
                               np.asarray(db_seq.recs_store[:db_seq.n]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_step_chain_dyn_matches_step_chain():
    """The dynamic-length chain (_step_chain_dyn: runtime trip count, one
    executable for every k <= buffer rows — the production step_chain_async
    lowering) must equal the legacy lax.scan lowering
    (step_chain_scan_async) record-for-record, including when k < the
    buffer length."""
    import jax.numpy as jnp

    cfg = PipelineConfig(cm=ContourManagerConfig(max_points=16384))
    world = make_world(12, n_structs=220, extent=160.0)
    poses = [(10.0 * i, 0.0, 0.0) for i in range(6)]
    poses += [(10.0 * (5 - i) + 0.5, 0.8, 0.15) for i in range(6)]
    ts = np.cumsum([1.0, 2.0, 16.0, 1.0, 30.0, 1.5,
                    1.0, 20.0, 2.0, 16.0, 1.0, 25.0]).astype(np.float32)
    clouds = np.stack([
        pad_points(render_scan(world, p, seed=800 + i), cfg.cm.max_points)
        for i, p in enumerate(poses)])
    n = len(poses)

    db_ref = ContourDB(cfg, capacity=32)
    # the LEGACY lax.scan lowering is the reference side here: production
    # step_chain_async now delegates to the dyn lowering,
    # so this test is what still pins scan-vs-dyn record parity
    href = db_ref.step_chain_scan_async(jnp.asarray(clouds), list(range(n)),
                                        ts)
    ref_recs = href.get()

    # same stream split as: dyn chain of 5 out of a 12-row buffer (k < K),
    # then a dyn chain of the remaining 7 out of a 7-row buffer (k == K)
    db_dyn = ContourDB(cfg, capacity=32)
    h1 = db_dyn.step_chain_dyn_async(jnp.asarray(clouds), list(range(5)), ts)
    h2 = db_dyn.step_chain_dyn_async(jnp.asarray(clouds[5:]),
                                     list(range(5, n)), ts[5:])
    dyn_recs = h1.get() + h2.get()

    assert len(ref_recs) == len(dyn_recs) == n
    n_found = 0
    for i, (rs, rc) in enumerate(zip(ref_recs, dyn_recs)):
        if rs is None:
            assert rc is None, (i, rc)
            continue
        assert rc is not None, (i, rs)
        n_found += 1
        assert rs[0] == rc[0], (i, rs, rc)
        np.testing.assert_allclose(rc[1], rs[1], rtol=1e-4)
        np.testing.assert_allclose(rc[2], rs[2], rtol=1e-4, atol=1e-5)
    assert n_found >= 1, ref_recs
    assert db_dyn.n == db_ref.n
    assert db_dyn.searchable_n == db_ref.searchable_n
    # An accelerator backend may lower the two chains differently (lax.scan
    # body vs the dyn path's fori/while body get independent fusion and
    # reduction order), so sub-threshold rows — stored here but never
    # surfaced as records — can drift a few mm in the GMM-refined pose.
    # Records the API returns are still pinned at
    # rtol=1e-4 above; only non-CPU backends get the looser whole-store band
    # (advisor r3: the CPU mesh keeps the original exact pin).
    import jax
    tol = (dict(rtol=1e-4, atol=1e-5) if jax.default_backend() == "cpu"
           else dict(rtol=1e-3, atol=5e-3))
    np.testing.assert_allclose(np.asarray(db_dyn.recs_store[:db_dyn.n]),
                               np.asarray(db_ref.recs_store[:db_ref.n]),
                               **tol)
